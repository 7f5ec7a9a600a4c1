// Row LayerNorm: bf16 or f32 rows in, f32 statistics, bf16 rows out.
//
// Replaces: the LN1/LN2 stages inside dfd_clip_tpu/ops/pallas_attention.py
// (_make_attn_block_kernel, _make_mlp_block_kernel), all of which follow
// models/layers.py:layer_norm (f32 mean and variance, eps 1e-5, cast back to
// the activation type), and the LN2 of the bf16 whole block
// (_make_full_block_kernel without int8_gemm), whose input is the f32
// residual stream hmid32 and whose output is cast to bf16 for c_fc. (The
// LN2 / LN1' stages of dfd_clip_tpu/ops/pallas_decoder_stack.py run inside
// the decoder boundary's kernel, csrc/decoder_boundary.cu, on this body.)
//
// Bound on an H100: bytes. Each row is read once from device memory and
// written once (2 + 2 bytes a value from bf16, 4 + 2 from f32, against ~8
// FLOP a value): 0.0578 ms at ViT-B/16's 63,040 x 768 rows, 0.0754 at
// DINOv2's 82,240 x 768, 0.1006 at ViT-L/14's 82,240 x 1024 and 0.2258 at
// ViT-L/14@336px's 184,640 x 1024 (bf16 in).
//
// Design (layer_norm_quant's, csrc/quant_rows.cu): a persistent grid, as
// many 4-warp blocks as are resident at once, each warp walking rows
// grid-stride. A warp holds its row in registers (CH = ceil(W / 256) chunks
// of 8 values a lane, 16-byte loads; a template over CH = 1..8, so W <=
// 2048), so the row is read from device memory once, and issues the next
// row's loads before the current row's two reductions, so a row's bytes are
// always in flight. Up to 1024 values a row the lane's slices of scale and
// shift are loaded once a warp, as 16-byte vectors, into registers; wider
// rows read them at each use (from L1), which keeps the registers within
// the budget that holds two rows in flight. The arithmetic is
// row_ops::ln_values (csrc/rows.cuh), which the tower's LayerNorm stages
// and the decoder boundary run too: the towers stay bit-equal to their
// per-layer chains. The outputs go out as 16-byte stores. A masked last
// chunk takes widths that are not a multiple of 256 (32, 64, 384, ...).
#include <type_traits>

#include "rows.cuh"

namespace {

constexpr int WARPS = 4;           // warps a block
constexpr int MAX_CHUNKS = 8;      // W <= 2048
constexpr int REG_CHUNKS = 4;      // scale / shift in registers up to W = 1024

template <typename T, int CH>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const T* __restrict__ x, int ldx, const float* __restrict__ scale,
                  const float* __restrict__ shift, bf16* __restrict__ y, int ldy, int rows,
                  int width, float eps) {
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * WARPS;
  int r = blockIdx.x * WARPS + threadIdx.x / 32;
  std::conditional_t<CH <= REG_CHUNKS, row_ops::AffineRegs<CH>, row_ops::AffinePtr> aff;
  if constexpr (CH <= REG_CHUNKS)
    aff.load(scale, shift, width, lane);
  else
    aff = row_ops::AffinePtr{scale, shift};
  row_ops::Raw8<T> cur[CH], nxt[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (r < rows && c < width) cur[i].load(x + (size_t)r * ldx + c);
  }
  for (; r < rows; r += stride) {
    const int rn = r + stride;
#pragma unroll
    for (int i = 0; i < CH; ++i) {   // the next row in flight during this one
      const int c = lane * 8 + i * 256;
      if (rn < rows && c < width) nxt[i].load(x + (size_t)rn * ldx + c);
    }
    float v[CH][8];
#pragma unroll
    for (int i = 0; i < CH; ++i) cur[i].widen(v[i]);
    row_ops::ln_values(v, aff, width, eps, lane);
    row_ops::store_ln_row(v, y + (size_t)r * ldy, width, lane);
#pragma unroll
    for (int i = 0; i < CH; ++i) cur[i] = nxt[i];
  }
}

template <typename T, int CH>
int launch(const T* x, int ldx, const float* scale, const float* shift, bf16* y, int ldy,
           int rows, int width, float eps, cudaStream_t st) {
  cudaError_t err;
  const int grid = row_ops::persistent_grid<layer_norm_kernel<T, CH>>(WARPS, rows, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_kernel<T, CH>
      <<<grid, WARPS * 32, 0, st>>>(x, ldx, scale, shift, y, ldy, rows, width, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CH = 1>
int dispatch(const T* x, int ldx, const float* scale, const float* shift, bf16* y, int ldy,
             int rows, int width, float eps, cudaStream_t st) {
  if constexpr (CH < MAX_CHUNKS) {
    if ((width + 255) / 256 > CH)   // 256-wide chunks a row
      return dispatch<T, CH + 1>(x, ldx, scale, shift, y, ldy, rows, width, eps, st);
  }
  return launch<T, CH>(x, ldx, scale, shift, y, ldy, rows, width, eps, st);
}

}  // namespace

// y[rows, width] = LN(x) with f32 scale/shift, x f32 when x_f32, else bf16;
// width % 8 == 0, width <= 2048, and leading dimensions multiples of 8 (the
// wrapper checks).
extern "C" int dfd_layer_norm(const void* x, int ldx, int x_f32, const float* scale,
                              const float* shift, void* y, int ldy, int rows, int width,
                              float eps, void* stream) {
  if (rows < 0 || width < 8 || width > MAX_CHUNKS * 256 || width % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* yy = static_cast<bf16*>(y);
  if (x_f32)
    return dispatch(static_cast<const float*>(x), ldx, scale, shift, yy, ldy, rows, width, eps,
                    st);
  return dispatch(static_cast<const bf16*>(x), ldx, scale, shift, yy, ldy, rows, width, eps, st);
}
