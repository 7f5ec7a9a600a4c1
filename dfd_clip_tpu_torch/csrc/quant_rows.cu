// Per-row absmax int8 quantisation of GEMM inputs and of the K/V export, and
// LayerNorm fused with that quantisation.
//
// Replaces: the in-kernel quantisation stages of
// dfd_clip_tpu/ops/pallas_attention.py: _quant_rows (the W8A8 activation
// quantiser: s = max|y| + 1e-8, q = clip(round(y * (127 / s)), -127, 127)),
// _quant_kv_rows (the int8_rows K/V export: s = max|r| * (1/127) + 1e-30,
// q = clip(round(r * (1 / s)), -127, 127), written by _write_kv_export with
// zero pad rows and zero pad scales), and the LN1 / LN2 stages of
// _make_full_block_kernel, whose f32 LayerNorm output is quantised without a
// bf16 round trip.
//
// Bound on an H100: bytes. Each row is read once (f32 or bf16) and written
// once as int8 plus one f32 scale; a handful of operations per element.
//
// Design: one warp per row. quant_rows reads the row twice (the absmax, then
// the quantisation; the second read hits L1 or L2), with 16-byte loads of 8
// elements a lane and 8-byte int8 stores. layer_norm_quant keeps the row
// (W <= 1024) in registers: mean, centred variance (the two-pass form jnp.var
// uses), normalise, absmax, quantise. The scale and the quotient 127 / s are
// IEEE divisions (the build has no fast-math flag), the products and sums use
// __fmul_rn / __fadd_rn so none is fused into an FMA, and rintf rounds half to
// even as jnp.round does. The K/V form maps input row r (frame r / T, token
// r % T) to output row frame * T' + token - lo, drops tokens < lo, and the
// frame's last token also writes the T' - (T - lo) zero pad rows and scales,
// so a stacked export slot needs no zeroing pass. The row bodies live in
// csrc/rows.cuh, shared with csrc/encoder_tower.cu.
#include "rows.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
quant_rows_kernel(const T* __restrict__ x, int ldx, int rows, int cols, bool kv,
                  int8_t* __restrict__ q, int ldq, float* __restrict__ s, int tokens, int t_out,
                  int lo) {
  const int r = blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  row_ops::quant_row(x, ldx, r, cols, kv, q, ldq, s, tokens, t_out, lo, threadIdx.x % 32);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_quant_kernel(const T* __restrict__ x, int ldx, const float* __restrict__ scale,
                        const float* __restrict__ shift, int rows, int width, float eps,
                        int8_t* __restrict__ q, float* __restrict__ s) {
  const int r = blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  row_ops::layer_norm_quant(x, ldx, r, scale, shift, width, eps, q, s, threadIdx.x % 32);
}

}  // namespace

// q, s = quantise the rows of x[rows, cols] (f32 when x_f32, else bf16; row
// stride ldx elements). kv = 0: the _quant_rows constants, q row r at q + r *
// ldq, s[r]. kv = 1: the _quant_kv_rows constants with the export mapping
// described above (tokens = T, t_out = T', lo); pass tokens = t_out = rows and
// lo = 0 for a plain row-to-row map. cols % 8 == 0, 16-byte aligned rows (the
// wrapper checks).
extern "C" int dfd_quant_rows(const void* x, int ldx, int x_f32, int rows, int cols, int kv,
                              void* q, int ldq, float* s, int tokens, int t_out, int lo,
                              void* stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    quant_rows_kernel<float><<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const float*>(x), ldx, rows, cols, kv != 0, static_cast<int8_t*>(q), ldq, s,
        tokens, t_out, lo);
  else
    quant_rows_kernel<bf16><<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const bf16*>(x), ldx, rows, cols, kv != 0, static_cast<int8_t*>(q), ldq, s,
        tokens, t_out, lo);
  return static_cast<int>(cudaGetLastError());
}

// q[rows, width] int8, s[rows] f32 = _quant_rows(LN(x)) with f32 statistics
// and f32 scale/shift; x f32 when x_f32, else bf16, row stride ldx. width %
// 8 == 0 and width <= 1024 (the wrapper checks).
extern "C" int dfd_layer_norm_quant(const void* x, int ldx, int x_f32, const float* scale,
                                    const float* shift, int rows, int width, float eps, void* q,
                                    float* s, void* stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    layer_norm_quant_kernel<float><<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const float*>(x), ldx, scale, shift, rows, width, eps,
        static_cast<int8_t*>(q), s);
  else
    layer_norm_quant_kernel<bf16><<<blocks, WARPS * 32, 0, st>>>(
        static_cast<const bf16*>(x), ldx, scale, shift, rows, width, eps,
        static_cast<int8_t*>(q), s);
  return static_cast<int>(cudaGetLastError());
}
