// The int8 GEMM's block body: one 128x128 output tile of the W8A8 product
// with its dequant epilogue. csrc/gemm_s8.cu runs one tile per block;
// csrc/encoder_tower.cu walks the tiles of a stage in a loop. The design is
// described in gemm_s8.cu.
#pragma once

#include "common.cuh"

namespace s8_gemm {

constexpr int BM = 128, BN = 128, BK = 64;   // BK in int8 elements (bytes)
constexpr int LDS = BK + 16;                 // shared-memory row pitch, bytes
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int A_STAGE = BM * LDS;            // bytes per stage
constexpr int B_STAGE = BN * LDS;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);

enum : int {
  kGelu = 1,       // v = v * sigmoid(1.702 v)         (f32)
  kResF32 = 2,     // v = res + v, res f32              (f32)
  kResBf16 = 4,    // v = res + v, res bf16 widened     (f32)
  kOutF32 = 8,     // C is f32 (else bf16)
  kStore = 16,     // write C
  kExport = 32,    // write the K/V columns into the stacked export buffers
  kResAfterCast = 64,   // v = res + bf16(v), res bf16    (bf16 output)
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

// The tile at rows m0.., columns n0.. of C = epilogue(A[M,K] int8 @
// B[N,K]^T int8); smem holds SMEM_BYTES. Every thread of a 256-thread block
// calls it.
template <bool RES_AFTER_CAST>
__device__ __forceinline__ void tile(const int8_t* __restrict__ A, int lda,
                                     const float* __restrict__ a_scale,
                                     const int8_t* __restrict__ B, int ldb,
                                     const float* __restrict__ w_scale,
                                     const float* __restrict__ bias,
                                     const void* __restrict__ res, int ldr, void* __restrict__ C,
                                     int ldc, int M, int N, int K, int flags, const Export& ex,
                                     int m0, int n0, unsigned char* smem) {
  unsigned char* As = smem;
  unsigned char* Bs = smem + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;          // mma fragment group and thread
  const int wm = warp / 2, wn = warp % 2;         // 4 x 2 warps, 32 x 64 each

  auto load_tile = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // A and B: 128 rows x 4 chunks of 16 bytes each
      const int c = tid + i * THREADS;
      const int r = c / 4, cc = (c % 4) * 16;
      const bool oka = m0 + r < M;
      cp_async16(As + buf * A_STAGE + r * LDS + cc,
                 oka ? A + (size_t)(m0 + r) * lda + k0 + cc : A, oka);
      const bool okb = n0 + r < N;
      cp_async16(Bs + buf * B_STAGE + r * LDS + cc,
                 okb ? B + (size_t)(n0 + r) * ldb + k0 + cc : B, okb);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
    const unsigned char* at = As + (kt % STAGES) * A_STAGE;
    const unsigned char* bt = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[2][4], bfr[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* p = at + (wm * 32 + i * 16 + g) * LDS + kk + t4 * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned char* p = bt + (wn * 64 + j * 8 + g) * LDS + kk + t4 * 4;
        bfr[j][0] = *reinterpret_cast<const unsigned*>(p);
        bfr[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: accumulator e of tile (i, j) is row g (+8 for e >= 2), column
  // 2 * t4 + (e & 1) of the tile.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + i * 16 + g + half * 8;
      if (row >= M) continue;
      const float ar = a_scale[row] / 127.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + 2 * t4;
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float wc = w_scale[col + e] / 127.0f;
          float x = __fmul_rn(__fmul_rn(static_cast<float>(acc[i][j][half * 2 + e]), ar), wc);
          x = __fadd_rn(x, bias[col + e]);
          if (flags & kGelu) x = __fmul_rn(x, 1.0f / (1.0f + expf(-1.702f * x)));
          const size_t at = (size_t)row * ldr + col + e;
          if (flags & kResF32) x = __fadd_rn(static_cast<const float*>(res)[at], x);
          if (flags & kResBf16)
            x = __fadd_rn(__bfloat162float(static_cast<const bf16*>(res)[at]), x);
          if (RES_AFTER_CAST)
            x = __fadd_rn(__bfloat162float(static_cast<const bf16*>(res)[at]), bf16r(x));
          v[e] = x;
        }
        if (flags & kOutF32) {
          if (flags & kStore)
            *reinterpret_cast<float2*>(static_cast<float*>(C) + (size_t)row * ldc + col) =
                make_float2(v[0], v[1]);
          continue;
        }
        const __nv_bfloat162 out = __floats2bfloat162_rn(v[0], v[1]);
        if (flags & kStore)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + (size_t)row * ldc + col) = out;
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
              *reinterpret_cast<__nv_bfloat162*>(dst + (base + d) * ex.width + cc) = out;
            if (tok == ex.tokens - 1) {
              const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
              for (int p = ex.tokens - ex.lo; p < ex.t_out; ++p)
                *reinterpret_cast<__nv_bfloat162*>(dst + (base + p) * ex.width + cc) = zero;
            }
          }
        }
      }
    }
  }
}

}  // namespace s8_gemm
