// Row bodies, one warp per row: LayerNorm (csrc/layer_norm.cu), the per-row
// int8 quantisers and LayerNorm fused with the quantisation
// (csrc/quant_rows.cu). Each kernel runs one row per warp; the whole-encoder
// tower (csrc/encoder_tower.cuh) walks a stage's rows over every warp of its
// grid. The designs are described in those two files.
#pragma once

#include "common.cuh"

namespace row_ops {

constexpr int LN_CHUNKS = 4;   // 8-element chunks per lane of layer_norm_quant: W <= 4 * 256

// y = LN(x) of one row with f32 statistics (x bf16 or f32), bf16 out.
template <typename T>
__device__ __forceinline__ void layer_norm(const T* __restrict__ xr,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift, bf16* __restrict__ yr,
                                           int width, float eps, int lane) {
  float s = 0.f;
  for (int c = lane * 8; c < width; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
  }
  const float mean = warp_sum(s) / width;
  float q = 0.f;
  for (int c = lane * 8; c < width; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float d = v[e] - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / width + eps);
  for (int c = lane * 8; c < width; c += 256) {
    float v[8];
    Pack8 o;
    load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o.h[e] = __float2bfloat16((v[e] - mean) * rstd * scale[c + e] + shift[c + e]);
    *reinterpret_cast<uint4*>(yr + c) = o.u;
  }
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

// (scale, multiplier) of the two quantisers for a row maximum `amax`.
__device__ __forceinline__ float2 quant_consts(float amax, bool kv) {
  if (kv) {
    const float s = __fadd_rn(__fmul_rn(amax, 1.0f / 127.0f), 1e-30f);
    return make_float2(s, 1.0f / s);
  }
  const float s = __fadd_rn(amax, 1e-8f);
  return make_float2(s, 127.0f / s);
}

// Quantise input row r of x (frame r / tokens, token r % tokens) into
// output row frame * t_out + token - lo of q and s; the frame's last token
// also writes the zero pad rows and scales. tokens = t_out = rows, lo = 0
// is the plain row-to-row map.
template <typename T>
__device__ __forceinline__ void quant_row(const T* __restrict__ x, int ldx, int r, int cols,
                                          bool kv, int8_t* __restrict__ q, int ldq,
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
  const float2 sc = quant_consts(warp_max(amax), kv);
  const size_t out = base + tok - lo;
  for (int c = lane * 8; c < cols; c += 256) {
    float v[8];
    load8(xr + c, v);
    store_q8(q + out * ldq + c, v, sc.y);
  }
  if (lane == 0) s[out] = sc.x;
}

// The affine parameters of layer_norm_quant: read at each use (the tower's
// row stage), or a lane's slices held in registers (csrc/quant_rows.cu).
struct AffinePtr {
  const float* scale;
  const float* shift;
  __device__ __forceinline__ float mul(int, int e, int c) const { return scale[c + e]; }
  __device__ __forceinline__ float add(int, int e, int c) const { return shift[c + e]; }
};

template <int CH>
struct AffineRegs {
  float sc[CH][8], sh[CH][8];
  __device__ __forceinline__ float mul(int i, int e, int) const { return sc[i][e]; }
  __device__ __forceinline__ float add(int i, int e, int) const { return sh[i][e]; }
};

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
