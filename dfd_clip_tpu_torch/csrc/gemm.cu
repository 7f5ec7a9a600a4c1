// Tiled bf16 GEMM on the tensor cores with the fused epilogues of the
// encoder and decoder blocks.
//
// Replaces: the in-kernel GEMMs of dfd_clip_tpu/ops/pallas_attention.py
// (_make_attn_block_kernel: qkv projection + K/V export + out-projection;
// _make_mlp_block_kernel: c_fc + QuickGELU, c_proj + residual;
// _make_full_block_kernel without int8_gemm: its four GEMMs) and of
// dfd_clip_tpu/ops/pallas_decoder_stack.py (_boundary_kernel's linear_bf16).
//
// Bound on an H100: at encoder shapes (M = 320 frames x 197 tokens, K = 768
// or 3072) the product is bound by tensor-core operations (about 2*M*N*K
// FLOP against 2*(M*K + K*N + M*N) bytes, far above the card's ~295 FLOP per
// byte). At the decoder boundary (M = 16) it is bound by the weight bytes
// and, in practice, by launch latency.
//
// Design: 128x128 output tile per block, 8 warps each owning 32x64 through
// nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulate; K steps of 32
// in a 3-stage cp.async ring in dynamic shared memory (57 KB), so two tiles
// load while one multiplies, and registers capped at 128 a thread so two
// blocks share an SM. The epilogue stages each 16x16 accumulator in a
// per-warp slice of the drained ring and applies, in this order: bias (f32
// before the bf16 cast, the encoder kernels' rule, or bf16 after it, layers.linear's
// rule), QuickGELU in f32, the bf16 residual add, the store, and the K/V
// export of the qkv projection: K and V columns of every non-CLS token row go
// straight into slot `slot` of the stacked (Lsel, N, T', W) buffers, and the
// row of each frame's last token also writes that frame's zero pad rows, so
// the buffers need no zeroing pass. The bf16 whole block
// (_make_full_block_kernel without int8_gemm) keeps its residual stream
// between the halves in f32: its out-projection writes f32 with the bf16 h
// added in f32, and its c_proj adds that f32 stream before the one bf16
// rounding. Those two forms are a separate instantiation (WIDE) of the same
// body (csrc/gemm_tile.cuh, shared with csrc/encoder_tower.cu), so the other
// epilogues compile as before. A wgmma/TMA pipeline is later work.
#include "gemm_tile.cuh"

namespace {

using namespace bf16_gemm;

template <bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
            void* __restrict__ C, int ldc, int M, int N, int K, const float* __restrict__ bias,
            const void* __restrict__ res, int ldr, int flags, Export ex) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile<WIDE>(A, lda, B, ldb, C, ldc, M, N, K, bias, res, ldr, flags, ex, blockIdx.y * BM,
             blockIdx.x * BN, smem);
}

}  // namespace

// C = epilogue(A[M,K] @ B[K,N]); A, B row-major bf16, C bf16 (f32 with
// kOutF32), res bf16 (f32 with kResIsF32), with the given leading
// dimensions. K % 32 == 0, N % 8 == 0 and every leading dimension a multiple
// of 8 (16-byte rows); the wrapper checks. Returns the launch's
// cudaGetLastError().
extern "C" int dfd_gemm(const void* A, int lda, const void* B, int ldb, void* C, int ldc,
                        int M, int N, int K, const float* bias, const void* res, int ldr,
                        int flags, void* k_out, void* v_out, int tokens, int t_out, int lo,
                        int width, int col_off, void* stream) {
  Export ex{static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), tokens, t_out, lo, width,
            col_off};
  const bool wide = flags & (kOutF32 | kResAddF32);
  auto kernel = wide ? gemm_kernel<true> : gemm_kernel<false>;
  static bool configured[2] = {false, false};
  if (!configured[wide]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[wide] = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb, C, ldc, M, N, K, bias,
      res, ldr, flags, ex);
  return static_cast<int>(cudaGetLastError());
}
