// int8 x int8 -> int32 GEMM on the tensor cores with the W8A8 dequant
// epilogue of the int8 encoder blocks.
//
// Replaces: the in-kernel W8A8 products of dfd_clip_tpu/ops/pallas_attention.py
// (_w8a8_dot with the per-row activation scales of _quant_rows and the
// per-channel weight scales of quantize_weight / weight_q) in
// _make_full_block_kernel (qkv + K/V export, out-proj + f32 residual, c_fc +
// QuickGELU, c_proj + f32 residual) and in the int8 `last_only` form of
// _make_attn_block_kernel.
//
// Bound on an H100: at encoder shapes (M = 320 frames x 197 tokens, K = 768
// or 3072) the product is bound by int8 tensor-core operations (2*M*N*K
// against M*K + N*K bytes of operands and 2-4 bytes per output element), far
// above the card's ~590 int8 operations per byte.
//
// Design: 128x128 output tile per block, 8 warps each owning 32x64 as 2 x 8
// mma.sync.m16n8k32 s8 tiles with int32 accumulators in registers (the int32
// sum is exact: K * 127^2 < 2^31 up to K = 133,000). The weight is stored
// transposed, (N, K), so both operands are K-contiguous rows and every
// fragment register is one aligned 32-bit shared-memory load; the 80-byte row
// pitch puts the 32 lanes of a fragment load on 32 distinct banks. K steps of
// 64 bytes run through a 3-stage cp.async ring (60 KB of dynamic shared
// memory), registers capped at 128 a thread so two blocks share an SM. The
// epilogue works on the accumulator registers in place (each lane owns two
// neighbouring columns of two rows per tile) and follows the TPU kernel's
// order of f32 operations: acc * (a_s / 127) * (w_s / 127) + bias, QuickGELU,
// the f32 residual add, then the store as f32 or bf16 and, on the qkv
// projection, the K/V export of the bf16 values into slot views of the
// stacked (Lsel, N, T', W) buffers with the frame's zero pad rows. The int8
// MLP half of the split pair (_make_mlp_block_kernel) rounds its c_proj
// output to bf16 before it adds the bf16 residual (kResAfterCast, a separate
// instantiation so that the other epilogues compile as before). The
// products and sums are written with __fmul_rn / __fadd_rn so the compiler
// fuses none of them into an FMA, keeping the plain version's roundings. A
// wgmma/TMA pipeline is later work.
#include "common.cuh"

namespace {

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

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool RES_AFTER_CAST>
__global__ void __launch_bounds__(THREADS, 2)
gemm_s8_kernel(const int8_t* __restrict__ A, int lda, const float* __restrict__ a_scale,
               const int8_t* __restrict__ B, int ldb, const float* __restrict__ w_scale,
               const float* __restrict__ bias, const void* __restrict__ res, int ldr,
               void* __restrict__ C, int ldc, int M, int N, int K, int flags, Export ex) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* As = smem;
  unsigned char* Bs = smem + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;          // mma fragment group and thread
  const int wm = warp / 2, wn = warp % 2;         // 4 x 2 warps, 32 x 64 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

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

}  // namespace

// C = epilogue(A[M,K] int8 @ B[N,K]^T int8) with a_scale (M,), w_scale (N,)
// and bias (N,) f32; res (f32 or bf16, leading dimension ldr) and C (f32 or
// bf16, leading dimension ldc) as the flags say. K % 64 == 0, N % 8 == 0, the
// int8 leading dimensions multiples of 16 and the others of 8 (the wrapper
// checks). Returns the launch's cudaGetLastError().
extern "C" int dfd_gemm_s8(const void* A, int lda, const float* a_scale, const void* B, int ldb,
                           const float* w_scale, const float* bias, const void* res, int ldr,
                           void* C, int ldc, int M, int N, int K, int flags, void* k_out,
                           void* v_out, int tokens, int t_out, int lo, int width, int col_off,
                           void* stream) {
  Export ex{static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), tokens, t_out, lo, width,
            col_off};
  const bool after_cast = flags & kResAfterCast;
  auto kernel = after_cast ? gemm_s8_kernel<true> : gemm_s8_kernel<false>;
  static bool configured[2] = {false, false};
  if (!configured[after_cast]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[after_cast] = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(A), lda, a_scale, static_cast<const int8_t*>(B), ldb, w_scale,
      bias, res, ldr, C, ldc, M, N, K, flags, ex);
  return static_cast<int>(cudaGetLastError());
}
