// The bf16 GEMM's block body: one 128x128 output tile of epilogue(A @ B).
// csrc/gemm.cu runs one tile per block; csrc/encoder_tower.cu walks the
// tiles of a stage in a loop. The design is described in gemm.cu.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace bf16_gemm {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA_S = BK + 8;   // shared-memory row pitch (bf16) of the A tile
constexpr int LDB_S = BN + 8;   // shared-memory row pitch (bf16) of the B tile
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int A_STAGE = BM * LDA_S;   // bf16 elements per stage
constexpr int B_STAGE = BK * LDB_S;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;

enum : int {
  kBiasF32 = 1,      // v = acc + b                       (f32)
  kBiasBf16 = 2,     // v = bf16(bf16(acc) + bf16(b))     (layers.linear)
  kGelu = 4,         // v = v * sigmoid(1.702 v)          (f32)
  kResid = 8,        // out = bf16(res + bf16(v)), res bf16
  kStore = 16,       // write C
  kExport = 32,      // write K/V columns into the stacked export buffers
  // the wide epilogue (template WIDE), for the bf16 whole block's f32 hmid:
  kOutF32 = 64,      // C is f32
  kResAddF32 = 128,  // v = res + v in f32 before the output cast
  kResIsF32 = 256,   // ... with an f32 residual (else bf16, widened)
};

struct Export {
  bf16* k;          // slot base of the K buffer (N, T', W)
  bf16* v;          // slot base of the V buffer
  int tokens;       // T: token rows per frame in A
  int t_out;        // T': exported rows per frame (T - lo + pad)
  int lo;           // 1 drops the CLS row
  int width;        // W
  int col_off;      // column of C's first column in the packed [q|k|v] space
};

__device__ __forceinline__ float epilogue_value(float acc, const float* bias, int col, int flags) {
  float v = acc;
  if (flags & kBiasF32) v += bias[col];
  if (flags & kBiasBf16) v = bf16r(bf16r(v) + bf16r(bias[col]));
  if (flags & kGelu) v = v * (1.0f / (1.0f + expf(-1.702f * v)));
  return v;
}

// The tile at rows m0.., columns n0.. of C = epilogue(A[M,K] @ B[K,N]); smem
// holds SMEM_BYTES. Every thread of a 256-thread block calls it. WIDE adds
// the f32 output and the residual added in f32 (kOutF32, kResAddF32); the
// other epilogues are WIDE = false, which compiles as it did before the
// wide forms existed. Export is bf16 only.
template <bool WIDE>
__device__ __forceinline__ void tile(const bf16* __restrict__ A, int lda,
                                     const bf16* __restrict__ B, int ldb, void* __restrict__ C,
                                     int ldc, int M, int N, int K,
                                     const float* __restrict__ bias,
                                     const void* __restrict__ res, int ldr, int flags,
                                     const Export& ex, int m0, int n0, unsigned char* smem) {
  using namespace nvcuda;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;   // 4 x 2 warps, 32 x 64 each

  auto load_tile = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // A: 128 rows x 4 chunks of 8
      int c = tid + i * THREADS;
      int r = c / 4, cc = (c % 4) * 8;
      bool ok = m0 + r < M;
      const bf16* src = ok ? A + (size_t)(m0 + r) * lda + k0 + cc : A;
      cp_async16(&As[buf * A_STAGE + r * LDA_S + cc], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // B: 32 rows x 16 chunks of 8
      int c = tid + i * THREADS;
      int r = c / 16, cc = (c % 16) * 8;
      bool ok = n0 + cc < N;
      const bf16* src = ok ? B + (size_t)(k0 + r) * ldb + n0 + cc : B;
      cp_async16(&Bs[buf * B_STAGE + r * LDB_S + cc], src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s * BK);
    cp_async_commit();   // empty groups keep the wait count uniform
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();               // ... and every warp is done with kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load_tile(nk % STAGES, nk * BK);
    cp_async_commit();
    const bf16* at = As + (kt % STAGES) * A_STAGE;
    const bf16* bt = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], at + (wm * 32 + i * 16) * LDA_S + kk, LDA_S);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bfr[j], bt + kk * LDB_S + wn * 64 + j * 16, LDB_S);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is drained: reuse it for the epilogue

  // Epilogue: each lane owns 8 contiguous columns of one row of a 16x16 tile.
  float* st = reinterpret_cast<float*>(smem) + warp * 16 * 16;
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 32 + i * 16 + er;
      const int col = n0 + wn * 64 + j * 16 + ec;
      if (row < M && col < N) {
        if (WIDE) {
          float r[8], v[8];
          if (flags & kResAddF32) {
            const size_t at = (size_t)row * ldr + col;
            if (flags & kResIsF32) load8(static_cast<const float*>(res) + at, r);
            else load8(static_cast<const bf16*>(res) + at, r);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = epilogue_value(st[er * 16 + ec + e], bias, col + e, flags);
            if (flags & kResAddF32) v[e] = r[e] + v[e];
          }
          if (flags & kOutF32) {
            if (flags & kStore) {
              float* dst = static_cast<float*>(C) + (size_t)row * ldc + col;
              *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
              *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
            }
          } else if (flags & kStore) {
            Pack8 out;
#pragma unroll
            for (int e = 0; e < 8; ++e) out.h[e] = __float2bfloat16(v[e]);
            *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + (size_t)row * ldc + col) = out.u;
          }
        } else {
          Pack8 out;
          Pack8 rp;
          if (flags & kResid)
            rp.u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(res) +
                                                   (size_t)row * ldr + col);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float v = epilogue_value(st[er * 16 + ec + e], bias, col + e, flags);
            if (flags & kResid) v = __bfloat162float(rp.h[e]) + bf16r(v);
            out.h[e] = __float2bfloat16(v);
          }
          if (flags & kStore)
            *reinterpret_cast<uint4*>(static_cast<bf16*>(C) + (size_t)row * ldc + col) = out.u;
          if (flags & kExport) {
            const int colq = col + ex.col_off;
            if (colq >= ex.width) {
              const int which = (colq - ex.width) / ex.width;
              const int cc = (colq - ex.width) % ex.width;
              bf16* dst = which == 0 ? ex.k : ex.v;
              const int frame = row / ex.tokens, tok = row % ex.tokens;
              const int d = tok - ex.lo;
              const size_t base = (size_t)frame * ex.t_out;
              if (d >= 0)
                *reinterpret_cast<uint4*>(dst + (base + d) * ex.width + cc) = out.u;
              if (tok == ex.tokens - 1) {
                const uint4 zero = make_uint4(0, 0, 0, 0);
                for (int p = ex.tokens - ex.lo; p < ex.t_out; ++p)
                  *reinterpret_cast<uint4*>(dst + (base + p) * ex.width + cc) = zero;
              }
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace bf16_gemm
