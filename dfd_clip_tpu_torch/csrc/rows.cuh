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

union Int8x8 {
  uint2 u;
  int8_t q[8];
};

__device__ __forceinline__ void store_q8(int8_t* dst, const float* v, float inv) {
  Int8x8 o;
#pragma unroll
  for (int e = 0; e < 8; ++e) o.q[e] = quant8(v[e], inv);
  *reinterpret_cast<uint2*>(dst) = o.u;
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

// q row r, s[r] = _quant_rows(LN(x row r)) with f32 statistics, the row
// (W <= 1024) held in registers.
template <typename T>
__device__ __forceinline__ void layer_norm_quant(const T* __restrict__ x, int ldx, int r,
                                                 const float* __restrict__ scale,
                                                 const float* __restrict__ shift, int width,
                                                 float eps, int8_t* __restrict__ q,
                                                 float* __restrict__ s, int lane) {
  const T* xr = x + (size_t)r * ldx;
  float v[LN_CHUNKS][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) {
      load8(xr + c, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  }
  const float mean = warp_sum(sum) / width;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
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
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e] - mean, rstd), scale[c + e]),
                                  shift[c + e]);
        v[i][e] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  }
  const float2 sc = quant_consts(warp_max(amax), false);
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < width) store_q8(q + (size_t)r * width + c, v[i], sc.y);
  }
  if (lane == 0) s[r] = sc.x;
}

}  // namespace row_ops
