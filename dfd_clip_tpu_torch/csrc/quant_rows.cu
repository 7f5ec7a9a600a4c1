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
// bf16 round trip. Its third form is no TPU kernel's: the activation
// quantiser of the XLA W8A8 linear (dfd_clip_tpu/models/layers.py:
// linear_w8a8, the towers wider than 1024), s = max|x| + 1e-8 and q =
// clip(round(x / s * 127)), the quotient rounded before the product.
//
// Bound on an H100: bytes. Each row is read once (f32 or bf16) and written
// once as int8 plus one f32 scale; a handful of operations per element. At
// the int8 paths' shapes: quant_rows 0.0723 ms for the attention output
// (63,040 x 768 f32); layer_norm_quant (3 bytes a value from bf16, 5 from
// f32) 0.0434 / 0.0723 ms at 63,040 x 768, 0.0755 / 0.1257 at 82,240 x 1024,
// 0.1693 / 0.2822 at 184,640 x 1024.
//
// Design: quant_rows reads each row once. TPR threads take a row (32, 64,
// 128 or 256: the fewest that hold it in at most UNITS 16-byte loads of 8
// values a thread, 8192 values a row at most), 256-thread blocks of 256 /
// TPR rows; every thread issues all its loads first, so a block has its
// rows' bytes in flight at once. The row's maximum is taken by warp shuffles
// and, above 32 threads a row, one step through shared memory; the values
// are then quantised from the registers with 8-byte int8 stores (the linear
// form divides each value by s, then multiplies by 127). Wider rows
// take the warp-a-row body of csrc/rows.cuh, which reads the row twice.
// layer_norm_quant keeps the row (W <= 1024) in registers, one warp a row:
// mean, centred variance (the two-pass form jnp.var uses), normalise,
// absmax, quantise. Its grid is persistent (as many 4-warp blocks as are
// resident at once), each warp walking rows grid-stride: the warp loads its
// lanes' slices of scale and shift once, as 16-byte vectors, into registers
// (a lane's 8 values a 256-wide chunk, the chunks templated on the width),
// and issues the next row's loads before the current row's three
// reductions, so a row's bytes are always in flight. The scale and the
// quotient 127 / s are IEEE divisions (the build has no fast-math flag), the
// products and sums use __fmul_rn / __fadd_rn so none is fused into an FMA,
// and the rounding is half to even as jnp.round's (q8_bits, without a
// conversion instruction): the maximum is exact and each value's rounding
// its own, so every form, the tower's row stage (the same arithmetic,
// row_ops::ln_quant_values, with scale and shift read at each use)
// included, gives the same bits. The K/V form maps input row r (frame
// r / T, token r % T) to output row frame * T' + token - lo, drops tokens <
// lo, and the frame's last token also writes the T' - (T - lo) zero pad
// rows and scales, so a stacked export slot needs no zeroing pass. The row
// bodies of the tower (csrc/encoder_tower.cuh) live in csrc/rows.cuh.
#include "rows.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNITS = 4;   // 8-value loads a thread holds

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const T* __restrict__ x, int ldx, int rows, int cols, int form,
                  int8_t* __restrict__ q, int ldq, float* __restrict__ s, int tokens, int t_out,
                  int lo) {
  constexpr int WPR = TPR / 32;   // warps a row
  __shared__ float part[WARPS];
  const int lt = threadIdx.x % TPR, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * (THREADS / TPR) + threadIdx.x / TPR;
  const int frame = r / tokens, tok = r % tokens;
  const bool live = r < rows, read = live && tok >= lo;
  const T* xr = x + (size_t)r * ldx;
  float v[UNITS][8];
  float amax = 0.0f;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int c = 8 * (lt + u * TPR);
    if (read && c < cols) load8(xr + c, v[u]);
  }
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    if (read && 8 * (lt + u * TPR) < cols) {
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[u][e]));
    }
  }
  amax = warp_max(amax);
  if constexpr (WPR > 1) {
    if (lane == 0) part[warp] = amax;
    __syncthreads();
    const int w0 = warp / WPR * WPR;
#pragma unroll
    for (int w = 0; w < WPR; ++w) amax = fmaxf(amax, part[w0 + w]);
  }
  if (!live) return;
  const size_t base = (size_t)frame * t_out;
  if (tok == tokens - 1) {   // the frame's zero pad rows
    for (int p = tokens - lo; p < t_out; ++p) {
      for (int c = 8 * lt; c < cols; c += 8 * TPR)
        *reinterpret_cast<uint2*>(q + (base + p) * ldq + c) = make_uint2(0, 0);
      if (lt == 0) s[base + p] = 0.0f;
    }
  }
  if (!read) return;
  const float2 sc = row_ops::quant_consts(amax, form == row_ops::kQuantKv);
  const size_t out = base + tok - lo;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int c = 8 * (lt + u * TPR);
    if (c < cols) row_ops::store_q8_form(q + out * ldq + c, v[u], sc, form);
  }
  if (lt == 0) s[out] = sc.x;
}

// Wider rows: a warp a row, read twice.
template <typename T>
__global__ void __launch_bounds__(THREADS)
quant_rows_wide_kernel(const T* __restrict__ x, int ldx, int rows, int cols, int form,
                       int8_t* __restrict__ q, int ldq, float* __restrict__ s, int tokens,
                       int t_out, int lo) {
  const int r = blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  row_ops::quant_row(x, ldx, r, cols, form, q, ldq, s, tokens, t_out, lo, threadIdx.x % 32);
}

template <typename T>
int launch_quant_rows(const T* x, int ldx, int rows, int cols, int form, int8_t* q, int ldq,
                      float* s, int tokens, int t_out, int lo, cudaStream_t st) {
  const int units = cols / 8;
  int tpr = 32;
  while (tpr < THREADS && units > UNITS * tpr) tpr *= 2;
  if (units > UNITS * tpr) {
    quant_rows_wide_kernel<T><<<(rows + WARPS - 1) / WARPS, THREADS, 0, st>>>(
        x, ldx, rows, cols, form, q, ldq, s, tokens, t_out, lo);
    return static_cast<int>(cudaGetLastError());
  }
  const int per_block = THREADS / tpr;
  const dim3 grid((rows + per_block - 1) / per_block);
  auto kernel = tpr == 32    ? quant_rows_kernel<T, 32>
                : tpr == 64  ? quant_rows_kernel<T, 64>
                : tpr == 128 ? quant_rows_kernel<T, 128>
                             : quant_rows_kernel<T, 256>;
  kernel<<<grid, THREADS, 0, st>>>(x, ldx, rows, cols, form, q, ldq, s, tokens, t_out, lo);
  return static_cast<int>(cudaGetLastError());
}

constexpr int LNQ_WARPS = 4;   // warps a layer_norm_quant block

template <typename T, int CH>
__global__ void __launch_bounds__(LNQ_WARPS * 32)
layer_norm_quant_kernel(const T* __restrict__ x, int ldx, const float* __restrict__ scale,
                        const float* __restrict__ shift, int rows, int width, float eps,
                        int8_t* __restrict__ q, float* __restrict__ s) {
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * LNQ_WARPS;
  int r = blockIdx.x * LNQ_WARPS + threadIdx.x / 32;
  row_ops::AffineRegs<CH> aff;
  aff.load(scale, shift, width, lane);
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
    row_ops::ln_quant_values(v, aff, width, eps, q, s, r, lane);
#pragma unroll
    for (int i = 0; i < CH; ++i) cur[i] = nxt[i];
  }
}

template <typename T, int CH>
int launch_layer_norm_quant(const T* x, int ldx, const float* scale, const float* shift, int rows,
                            int width, float eps, int8_t* q, float* s, cudaStream_t st) {
  cudaError_t err;
  const int grid =
      row_ops::persistent_grid<layer_norm_quant_kernel<T, CH>>(LNQ_WARPS, rows, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_quant_kernel<T, CH>
      <<<grid, LNQ_WARPS * 32, 0, st>>>(x, ldx, scale, shift, rows, width, eps, q, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int layer_norm_quant(const T* x, int ldx, const float* scale, const float* shift, int rows,
                     int width, float eps, int8_t* q, float* s, cudaStream_t st) {
  switch ((width + 255) / 256) {   // 256-wide chunks a row
    case 1:
      return launch_layer_norm_quant<T, 1>(x, ldx, scale, shift, rows, width, eps, q, s, st);
    case 2:
      return launch_layer_norm_quant<T, 2>(x, ldx, scale, shift, rows, width, eps, q, s, st);
    case 3:
      return launch_layer_norm_quant<T, 3>(x, ldx, scale, shift, rows, width, eps, q, s, st);
    default:
      return launch_layer_norm_quant<T, 4>(x, ldx, scale, shift, rows, width, eps, q, s, st);
  }
}

}  // namespace

// q, s = quantise the rows of x[rows, cols] (f32 when x_f32, else bf16; row
// stride ldx elements) in `form` (row_ops::QuantForm). form 0: the
// _quant_rows constants, q row r at q + r * ldq, s[r]; form 2: the W8A8
// linear's, mapped as form 0. form 1: the _quant_kv_rows constants with the
// export mapping described above (tokens = T, t_out = T', lo); pass tokens =
// t_out = rows and lo = 0 for a plain row-to-row map. cols % 8 == 0, 16-byte
// aligned rows (the wrapper checks).
extern "C" int dfd_quant_rows(const void* x, int ldx, int x_f32, int rows, int cols, int form,
                              void* q, int ldq, float* s, int tokens, int t_out, int lo,
                              void* stream) {
  if (form < row_ops::kQuantRows || form > row_ops::kQuantLinear)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  if (x_f32)
    return launch_quant_rows(static_cast<const float*>(x), ldx, rows, cols, form, qq, ldq, s,
                             tokens, t_out, lo, st);
  return launch_quant_rows(static_cast<const bf16*>(x), ldx, rows, cols, form, qq, ldq, s,
                           tokens, t_out, lo, st);
}

// q[rows, width] int8, s[rows] f32 = _quant_rows(LN(x)) with f32 statistics
// and f32 scale/shift; x f32 when x_f32, else bf16, row stride ldx. width %
// 8 == 0 and width <= 1024 (the wrapper checks).
extern "C" int dfd_layer_norm_quant(const void* x, int ldx, int x_f32, const float* scale,
                                    const float* shift, int rows, int width, float eps, void* q,
                                    float* s, void* stream) {
  if (rows < 0 || width < 8 || width > row_ops::LN_CHUNKS * 256 || width % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  if (x_f32)
    return layer_norm_quant(static_cast<const float*>(x), ldx, scale, shift, rows, width, eps,
                            qq, s, st);
  return layer_norm_quant(static_cast<const bf16*>(x), ldx, scale, shift, rows, width, eps, qq,
                          s, st);
}
