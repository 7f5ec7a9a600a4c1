// Row bodies, one warp per row: LayerNorm (csrc/layer_norm.cu), the per-row
// int8 quantisers and LayerNorm fused with the quantisation
// (csrc/quant_rows.cu). The persistent kernels walk rows grid-stride, a warp
// at a time; the whole-encoder tower (csrc/encoder_tower.cuh) walks a
// stage's rows over every warp of its grid, and the decoder boundary
// (csrc/decoder_boundary.cu) normalises its 16-row tiles with the same
// body. The designs are described in layer_norm.cu and quant_rows.cu.
#pragma once

#include "common.cuh"

namespace row_ops {

constexpr int LN_CHUNKS = 4;   // 8-element chunks a lane of the row forms: W <= 4 * 256

// One row's raw values at chunk granularity: a 16-byte word of 8 bf16, or
// two of 4 f32, loaded a row ahead and widened when the row's turn comes.
template <typename T>
struct Raw8;

template <>
struct Raw8<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void widen(float (&v)[8]) const {
    Pack8 pk;
    pk.u = u;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(pk.h[e]);
  }
};

template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void widen(float (&v)[8]) const {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
};

// The affine parameters of a LayerNorm: read at each use (the tower's row
// stages, the persistent kernel above 1024 values a row), or a lane's
// slices held in registers (the persistent kernels, the decoder boundary's
// tile).
struct AffinePtr {
  const float* scale;
  const float* shift;
  __device__ __forceinline__ float mul(int, int e, int c) const { return scale[c + e]; }
  __device__ __forceinline__ float add(int, int e, int c) const { return shift[c + e]; }
};

template <int CH>
struct AffineRegs {
  float sc[CH][8], sh[CH][8];
  __device__ __forceinline__ void load(const float* scale, const float* shift, int width,
                                       int lane) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < width) {
        load8(scale + c, sc[i]);
        load8(shift + c, sh[i]);
      }
    }
  }
  __device__ __forceinline__ float mul(int i, int e, int) const { return sc[i][e]; }
  __device__ __forceinline__ float add(int i, int e, int) const { return sh[i][e]; }
};

// LN(row) with f32 statistics, in place on the row's values in registers
// (W <= CH x 256; chunk i of v holds values lane * 8 + i * 256 on, chunks
// past the width unread): the lane's sum in chunk order, then the warp's;
// the mean; the centred squares in the same order (the two-pass form
// jnp.var uses); rstd = rsqrtf(q / W + eps); then (v - mean) * rstd * scale
// + shift with its one fused multiply-add. Every LayerNorm of the port that
// writes bf16 (layer_norm_rows, the tower's stages, the decoder boundary)
// runs this arithmetic, so they agree bit for bit at any CH.
template <int CH, typename Affine>
__device__ __forceinline__ void ln_values(float (&v)[CH][8], const Affine& aff, int width,
                                          float eps, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (lane * 8 + i * 256 < width) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
  }
  const float mean = warp_sum(s) / width;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (lane * 8 + i * 256 < width) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        q = __fmaf_rn(d, d, q);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / width + eps);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[i][e] = __fmaf_rn((v[i][e] - mean) * rstd, aff.mul(i, e, c), aff.add(i, e, c));
    }
  }
}

// The normalised row rounded to bf16, 16 bytes a chunk.
template <int CH>
__device__ __forceinline__ void store_ln_row(const float (&v)[CH][8], bf16* yr, int width,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) {
      Pack8 o;
#pragma unroll
      for (int e = 0; e < 8; ++e) o.h[e] = __float2bfloat16(v[i][e]);
      *reinterpret_cast<uint4*>(yr + c) = o.u;
    }
  }
}

// y = LN(x) of one row (x bf16 or f32, W <= LN_CHUNKS x 256), bf16 out, the
// row read once into registers and scale / shift read at each use: the
// tower's LayerNorm stages and the decoder boundary's.
template <typename T>
__device__ __forceinline__ void layer_norm(const T* xr, const float* scale, const float* shift,
                                           bf16* yr, int width, float eps, int lane) {
  float v[LN_CHUNKS][8];
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) load8(xr + c, v[i]);
  }
  ln_values(v, AffinePtr{scale, shift}, width, eps, lane);
  store_ln_row(v, yr, width, lane);
}

// The grid of the persistent row kernel KERNEL of `warps` warps a block: as
// many blocks as are resident at once (its occupancy, read once per
// kernel), fewer where the rows do not fill them. 0 on an error, with *err
// set.
template <auto KERNEL>
inline int persistent_grid(int warps, int rows, cudaError_t* err) {
  static int per_sm = 0;   // resident blocks an SM
  *err = cudaSuccess;
  if (per_sm == 0)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, warps * 32, 0);
  int dev = 0, sms = 0;
  if (*err == cudaSuccess) *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const long long need = ((long long)rows + warps - 1) / warps;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return static_cast<int>(need < resident ? need : resident);
}

// Eight values quantised (q8_bits) into one 8-byte store.
__device__ __forceinline__ void store_q8(int8_t* dst, const float* v, float inv) {
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t lo = __byte_perm(q8_bits(v[4 * h], inv), q8_bits(v[4 * h + 1], inv), 0x0040);
    const uint32_t hi =
        __byte_perm(q8_bits(v[4 * h + 2], inv), q8_bits(v[4 * h + 3], inv), 0x0040);
    w[h] = __byte_perm(lo, hi, 0x5410);
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

// Eight values quantised in the W8A8 linear's form, q = clip(round(v / s *
// 127)): the quotient, rounded, then the product (q8_bits on v / s), as
// models/layers.py:linear_w8a8 computes it.
__device__ __forceinline__ void store_q8_linear(int8_t* dst, const float* v, float s) {
  float t[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = __fdiv_rn(v[e], s);
  store_q8(dst, t, 127.0f);
}

// The row quantisers' forms (csrc/quant_rows.cu): _quant_rows', the K/V
// export's _quant_kv_rows', and the W8A8 linear's.
enum QuantForm : int { kQuantRows = 0, kQuantKv = 1, kQuantLinear = 2 };

// Eight values of a row in `form`, with the row's quant_consts `sc`.
__device__ __forceinline__ void store_q8_form(int8_t* dst, const float* v, float2 sc, int form) {
  if (form == kQuantLinear)
    store_q8_linear(dst, v, sc.x);
  else
    store_q8(dst, v, sc.y);
}

// (scale, multiplier) of the quantisers for a row maximum `amax`: the K/V
// form's, else s = max + 1e-8 with 127 / s (the linear form reads s only).
__device__ __forceinline__ float2 quant_consts(float amax, bool kv) {
  if (kv) {
    const float s = __fadd_rn(__fmul_rn(amax, 1.0f / 127.0f), 1e-30f);
    return make_float2(s, 1.0f / s);
  }
  const float s = __fadd_rn(amax, 1e-8f);
  return make_float2(s, 127.0f / s);
}

// Quantise input row r of x (frame r / tokens, token r % tokens) in `form`
// into output row frame * t_out + token - lo of q and s; the frame's last
// token also writes the zero pad rows and scales. tokens = t_out = rows,
// lo = 0 is the plain row-to-row map.
template <typename T>
__device__ __forceinline__ void quant_row(const T* __restrict__ x, int ldx, int r, int cols,
                                          int form, int8_t* __restrict__ q, int ldq,
                                          float* __restrict__ s, int tokens, int t_out, int lo,
                                          int lane) {
  const int frame = r / tokens, tok = r % tokens;
  const size_t base = (size_t)frame * t_out;
  if (tok == tokens - 1) {   // the frame's zero pad rows
    for (int p = tokens - lo; p < t_out; ++p) {
      for (int c = lane * 8; c < cols; c += 256)
        *reinterpret_cast<uint2*>(q + (base + p) * ldq + c) = make_uint2(0, 0);
      if (lane == 0) s[base + p] = 0.0f;
    }
  }
  if (tok < lo) return;
  const T* xr = x + (size_t)r * ldx;
  float amax = 0.0f;
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  const float2 sc = quant_consts(warp_max(amax), form == kQuantKv);
  const size_t out = base + tok - lo;
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    load8(xr + c, v);
    store_q8_form(q + out * ldq + c, v, sc, form);
  }
  if (lane == 0) s[out] = sc.x;
}

// q row r, s[r] = _quant_rows(LN(row)) with f32 statistics, the row (W <= CH
// x 256) in registers: chunk i of v holds values lane * 8 + i * 256 on.
// Every form (the tower's stage, csrc/quant_rows.cu) runs this arithmetic,
// so they agree bit for bit.
template <int CH, typename Affine>
__device__ __forceinline__ void ln_quant_values(float (&v)[CH][8], const Affine& aff, int width,
                                                float eps, int8_t* __restrict__ q,
                                                float* __restrict__ s, int r, int lane) {
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (lane * 8 + i * 256 < width) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  }
  const float mean = warp_sum(sum) / width;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (lane * 8 + i * 256 < width) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / width + eps);
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e] - mean, rstd), aff.mul(i, e, c)),
                                  aff.add(i, e, c));
        v[i][e] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  }
  const float2 sc = quant_consts(warp_max(amax), false);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) store_q8(q + (size_t)r * width + c, v[i], sc.y);
  }
  if (lane == 0) s[r] = sc.x;
}

// The same on row r of x (row stride ldx), read here, with scale / shift
// read at each use: the tower's row stage.
template <typename T>
__device__ __forceinline__ void layer_norm_quant(const T* __restrict__ x, int ldx, int r,
                                                 const float* __restrict__ scale,
                                                 const float* __restrict__ shift, int width,
                                                 float eps, int8_t* __restrict__ q,
                                                 float* __restrict__ s, int lane) {
  const T* xr = x + (size_t)r * ldx;
  float v[LN_CHUNKS][8];
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) load8(xr + c, v[i]);
  }
  ln_quant_values(v, AffinePtr{scale, shift}, width, eps, q, s, r, lane);
}

}  // namespace row_ops
