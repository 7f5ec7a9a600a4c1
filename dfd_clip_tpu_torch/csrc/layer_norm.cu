// Row LayerNorm: bf16 or f32 rows in, f32 statistics, bf16 rows out.
//
// Replaces: the LN1/LN2 stages inside dfd_clip_tpu/ops/pallas_attention.py
// (_make_attn_block_kernel, _make_mlp_block_kernel) and the LN2/LN1' stages
// of dfd_clip_tpu/ops/pallas_decoder_stack.py (_boundary_kernel), all of
// which follow models/layers.py:layer_norm (f32 mean and variance, eps 1e-5,
// cast back to the activation type), and the LN2 of the bf16 whole block
// (_make_full_block_kernel without int8_gemm), whose input is the f32
// residual stream hmid32 and whose output is cast to bf16 for c_fc.
//
// Bound on an H100: bytes. Each row is read once from device memory and
// written once (2 x 2 bytes per element against ~8 FLOP per element).
//
// Design: one warp per row. The row (1.5 KB at W = 768) is read three times
// by the same warp -- mean, centred variance (the two-pass form jnp.var
// uses), normalise -- and the second and third reads hit L1. 16-byte loads
// and stores keep neighbouring lanes on neighbouring addresses. The row body
// (csrc/rows.cuh) is a template on the input type, so the bf16 form
// compiles as before; csrc/encoder_tower.cu shares it.
#include "rows.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, int ldx, const float* __restrict__ scale,
                  const float* __restrict__ shift, bf16* __restrict__ y, int ldy, int rows,
                  int width, float eps) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  row_ops::layer_norm(x + (size_t)row * ldx, scale, shift, y + (size_t)row * ldy, width, eps,
                   threadIdx.x % 32);
}

}  // namespace

// y[rows, width] = LN(x) with f32 scale/shift, x f32 when x_f32, else bf16;
// width % 8 == 0 and leading dimensions multiples of 8 (the wrapper checks).
extern "C" int dfd_layer_norm(const void* x, int ldx, int x_f32, const float* scale,
                              const float* shift, void* y, int ldy, int rows, int width,
                              float eps, void* stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    layer_norm_kernel<float><<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const float*>(x), ldx, scale, shift, static_cast<bf16*>(y), ldy, rows,
        width, eps);
  else
    layer_norm_kernel<bf16><<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const bf16*>(x), ldx, scale, shift, static_cast<bf16*>(y), ldy, rows, width,
        eps);
  return static_cast<int>(cudaGetLastError());
}
