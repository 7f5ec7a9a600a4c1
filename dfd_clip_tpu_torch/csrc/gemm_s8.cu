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
// instantiation so that the other epilogues compile as before). The block
// body lives in csrc/gemm_s8_tile.cuh, shared with csrc/encoder_tower.cu. The
// products and sums are written with __fmul_rn / __fadd_rn so the compiler
// fuses none of them into an FMA, keeping the plain version's roundings. A
// wgmma/TMA pipeline is later work.
#include "gemm_s8_tile.cuh"

namespace {

using namespace s8_gemm;

template <bool RES_AFTER_CAST>
__global__ void __launch_bounds__(THREADS, 2)
gemm_s8_kernel(const int8_t* __restrict__ A, int lda, const float* __restrict__ a_scale,
               const int8_t* __restrict__ B, int ldb, const float* __restrict__ w_scale,
               const float* __restrict__ bias, const void* __restrict__ res, int ldr,
               void* __restrict__ C, int ldc, int M, int N, int K, int flags, Export ex) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile<RES_AFTER_CAST>(A, lda, a_scale, B, ldb, w_scale, bias, res, ldr, C, ldc, M, N, K, flags,
                       ex, blockIdx.y * BM, blockIdx.x * BN, smem);
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
