// Row LayerNorm: bf16 rows in, f32 statistics, bf16 rows out.
//
// Replaces: the LN1/LN2 stages inside dfd_clip_tpu/ops/pallas_attention.py
// (_make_attn_block_kernel, _make_mlp_block_kernel) and the LN2/LN1' stages
// of dfd_clip_tpu/ops/pallas_decoder_stack.py (_boundary_kernel), all of
// which follow models/layers.py:layer_norm (f32 mean and variance, eps 1e-5,
// cast back to the activation type).
//
// Bound on an H100: bytes. Each row is read once from device memory and
// written once (2 x 2 bytes per element against ~8 FLOP per element).
//
// Design: one warp per row. The row (1.5 KB at W = 768) is read three times
// by the same warp -- mean, centred variance (the two-pass form jnp.var
// uses), normalise -- and the second and third reads hit L1. 16-byte loads
// and stores keep neighbouring lanes on neighbouring addresses.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ scale,
                  const float* __restrict__ shift, bf16* __restrict__ y, int ldy, int rows,
                  int width, float eps) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * ldx;
  bf16* yr = y + (size_t)row * ldy;

  float s = 0.f;
  for (int c = lane * 8; c < width; c += 256) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += __bfloat162float(p.h[e]);
  }
  const float mean = warp_sum(s) / width;
  float q = 0.f;
  for (int c = lane * 8; c < width; c += 256) {
    Pack8 p;
    p.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float d = __bfloat162float(p.h[e]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / width + eps);
  for (int c = lane * 8; c < width; c += 256) {
    Pack8 p, o;
    p.u = *reinterpret_cast<const uint4*>(xr + c);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o.h[e] = __float2bfloat16((__bfloat162float(p.h[e]) - mean) * rstd * scale[c + e] +
                                shift[c + e]);
    *reinterpret_cast<uint4*>(yr + c) = o.u;
  }
}

}  // namespace

// y[rows, width] = LN(x) with f32 scale/shift; width % 8 == 0 and leading
// dimensions multiples of 8 (the wrapper checks).
extern "C" int dfd_layer_norm(const void* x, int ldx, const float* scale, const float* shift,
                              void* y, int ldy, int rows, int width, float eps, void* stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  layer_norm_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), ldx, scale, shift, static_cast<bf16*>(y), ldy, rows, width,
      eps);
  return static_cast<int>(cudaGetLastError());
}
