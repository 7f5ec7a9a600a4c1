// Single-query dual-activation (softmax + CoDA) decoder attention.
//
// Replaces: dfd_clip_tpu/ops/pallas_decoder_attention.py
// fused_decoder_attention (_kernel, forward, with and without `partials`; no
// int8 K/V scales): one query per (sample, head) over L = frames x patches
// tokens of slot `layer` of the stacked encoder export, with the shared
// temporal positional embedding added to K and V, the token mask, an exact
// online softmax, and CoDA's tanh(q_c . k) * 2 sigmoid(-|q_c - k|_1 * scale).
// The `partials` form (the training forward) writes the softmax state
// instead of the normalised output: the un-normalised numerator and the CoDA
// output (B, 2, H*D) f32, and the denominator and running maximum (B, 2, H)
// f32, both relative to the merged maximum.
//
// Bound on an H100: bytes. At the flagship shape (16 samples, 12 heads, 4000
// tokens, head_dim 64) a call reads ~197 MB of K/V for ~0.2 GFLOP.
//
// Design: one block per (sample, head), 8 warps. A warp takes 4 neighbouring
// tokens per step (4 independent K and V row loads in flight); a lane owns 2
// of the 64 dims, so each token's three reductions (softmax logit, CoDA
// logit, L1 distance) are warp shuffles. Each warp keeps its own running
// maximum, denominator, softmax numerator and CoDA sum in f32 registers, and
// the 8 warps combine through shared memory at the end. The stacked buffer is
// read at slot `layer` through a pointer offset, with no copy. Masked and
// out-of-range tokens contribute 0; the running maximum starts at the finite
// -1e30 of the TPU kernel and the denominator is floored at 1e-30, so a fully
// masked sample returns 0, not NaN (partials: numerator 0, denominator 0 and
// maximum -1e30).
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int WARPS = 8;
constexpr int UNROLL = 4;
constexpr float NEG_BIG = -1e30f;

template <bool PARTIALS>
__global__ void __launch_bounds__(WARPS * 32)
decoder_attention_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ qc, long long q_stride,
                         const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const unsigned char* __restrict__ mask, const bf16* __restrict__ pos,
                         bf16* __restrict__ out, float* __restrict__ o_sc, float* __restrict__ st,
                         int L, int heads, float scale) {
  __shared__ float sm_m[WARPS], sm_d[WARPS];
  __shared__ float sm_os[WARPS][D], sm_oc[WARPS][D];

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * 2;
  const size_t tok_stride = (size_t)heads * D;

  const __nv_bfloat162 qs2 =
      *reinterpret_cast<const __nv_bfloat162*>(qs + b * q_stride + h * D + d0);
  const __nv_bfloat162 qc2 =
      *reinterpret_cast<const __nv_bfloat162*>(qc + b * q_stride + h * D + d0);
  const float qs0 = __low2float(qs2), qs1 = __high2float(qs2);
  const float qc0 = __low2float(qc2), qc1 = __high2float(qc2);

  const bf16* kb = k + (size_t)b * L * tok_stride + h * D + d0;
  const bf16* vb = v + (size_t)b * L * tok_stride + h * D + d0;
  const unsigned char* mb = mask + (size_t)b * L;

  float m = NEG_BIG, den = 0.f, os0 = 0.f, os1 = 0.f, oc0 = 0.f, oc1 = 0.f;
  for (int l0 = warp * UNROLL; l0 < L; l0 += WARPS * UNROLL) {
    float k0[UNROLL], k1[UNROLL], v0[UNROLL], v1[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int l = l0 + u;
      ok[u] = l < L && mb[l] != 0;
      k0[u] = k1[u] = v0[u] = v1[u] = 0.f;
      if (ok[u]) {
        const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(kb + l * tok_stride);
        const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(vb + l * tok_stride);
        k0[u] = __low2float(kk);
        k1[u] = __high2float(kk);
        v0[u] = __low2float(vv);
        v1[u] = __high2float(vv);
        if (pos != nullptr) {
          const __nv_bfloat162 pp =
              *reinterpret_cast<const __nv_bfloat162*>(pos + l * tok_stride + h * D + d0);
          const float p0 = __low2float(pp), p1 = __high2float(pp);
          k0[u] += p0;
          k1[u] += p1;
          v0[u] += p0;
          v1[u] += p1;
        }
      }
    }
    float ls[UNROLL], wc[UNROLL];
    float tile_max = NEG_BIG;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float s = warp_sum(qs0 * k0[u] + qs1 * k1[u]) * scale;
      const float c = warp_sum(qc0 * k0[u] + qc1 * k1[u]) * scale;
      const float l1 = warp_sum(fabsf(qc0 - k0[u]) + fabsf(qc1 - k1[u]));
      ls[u] = s;
      wc[u] = ok[u] ? tanhf(c) * (2.0f / (1.0f + expf(l1 * scale))) : 0.f;
      if (ok[u]) tile_max = fmaxf(tile_max, s);
    }
    const float m_new = fmaxf(m, tile_max);
    const float fac = expf(m - m_new);
    den *= fac;
    os0 *= fac;
    os1 *= fac;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = ok[u] ? expf(ls[u] - m_new) : 0.f;
      den += p;
      os0 += p * v0[u];
      os1 += p * v1[u];
      oc0 += wc[u] * v0[u];
      oc1 += wc[u] * v1[u];
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_d[warp] = den;
  }
  sm_os[warp][d0] = os0;
  sm_os[warp][d0 + 1] = os1;
  sm_oc[warp][d0] = oc0;
  sm_oc[warp][d0 + 1] = oc1;
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    float mm = NEG_BIG;
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, sm_m[w]);
    float dd = 0.f, o_s = 0.f, o_c = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w] - mm);
      dd += sm_d[w] * f;
      o_s += sm_os[w][d] * f;
      o_c += sm_oc[w][d];
    }
    if (PARTIALS) {
      float* row = o_sc + (size_t)b * 2 * tok_stride + h * D + d;
      row[0] = o_s;
      row[tok_stride] = o_c;
      if (d == 0) {
        st[(size_t)b * 2 * heads + h] = dd;
        st[(size_t)b * 2 * heads + heads + h] = mm;
      }
    } else {
      out[(size_t)b * tok_stride + h * D + d] = __float2bfloat16(0.5f * (o_s / fmaxf(dd, 1e-30f) + o_c));
    }
  }
}

}  // namespace

// out[B, H, 64] from queries (row stride q_stride elements between samples,
// heads x 64 contiguous), K/V [B, L, H, 64] (already offset to the slot),
// mask [B, L] bytes, and pos [L, H, 64] or null. The wrapper checks shapes.
extern "C" int dfd_decoder_attention(const void* qs, const void* qc, long long q_stride,
                                     const void* k, const void* v, const void* mask,
                                     const void* pos, void* out, int batch, int L, int heads,
                                     float scale, void* stream) {
  decoder_attention_kernel<false><<<batch * heads, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(qc), q_stride,
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(mask), static_cast<const bf16*>(pos),
      static_cast<bf16*>(out), nullptr, nullptr, L, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// The partials form: o_sc [B, 2, H * 64] f32 (numerator, CoDA output) and
// st [B, 2, H] f32 (denominator, maximum), same inputs.
extern "C" int dfd_decoder_attention_partials(const void* qs, const void* qc, long long q_stride,
                                              const void* k, const void* v, const void* mask,
                                              const void* pos, void* o_sc, void* st, int batch,
                                              int L, int heads, float scale, void* stream) {
  decoder_attention_kernel<true><<<batch * heads, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(qc), q_stride,
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(mask), static_cast<const bf16*>(pos), nullptr,
      static_cast<float*>(o_sc), static_cast<float*>(st), L, heads, scale);
  return static_cast<int>(cudaGetLastError());
}
