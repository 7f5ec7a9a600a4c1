// Backward of the single-query dual-activation decoder attention, for the
// trainable leaves: dq_smax, dq_coda and the temporal positional embedding's
// cotangent dpos, in one pass over K and V.
//
// Replaces: dfd_clip_tpu/ops/pallas_decoder_attention.py
// fused_decoder_attention_bwd (_bwd_kernel). Math of
// ops/decoder_attention_vjp._bwd_math: per valid token, with kp = k + pos,
// vp = v + pos and the forward's saved softmax state (max, denominator),
//   a_s = exp(ls - max) / denom, t = tanh(lc), g = 2 sigmoid(-|qc - kp|_1 s)
//   da = 0.5 g0 . vp
//   dls = a_s (da - S)        S = 0.5 sum_d g0 o_s (the wrapper computes it)
//   dlc = da g (1 - t^2),  du = -s da t g (1 - g / 2)
//   dq_smax = s sum_l dls kp,  dq_coda = s sum_l dlc kp + sum_l du sign(qc - kp)
//   dpos[l] = sum_b dls qs s + dlc qc s - du sign(qc - kp) + 0.5 (a_s + t g) g0
// S removes the global softmax coupling term, so a single pass suffices.
// The logits are recomputed with the forward kernel's own arithmetic
// (csrc/decoder_attention.cu: k + pos in f32 from bf16 values, the same lane
// layout and warp-shuffle order), so exp(ls - max) with the saved max is
// the forward's value and stays <= 1. Masked and out-of-range tokens
// contribute exactly 0: a fully masked sample (denominator 0) gives dq = 0
// and adds nothing to dpos.
//
// Bound on an H100: bytes. At the flagship train shape (12 samples, 12 heads,
// 4000 tokens, head_dim 64) a call reads ~147 MB of K/V for ~1 GFLOP.
//
// Design: dq is a sum over L per (sample, head) and dpos a sum over samples
// per (token, head), so the two reductions run in opposite directions. One
// block per (64-token tile, head), 8 warps of 8 tokens each: a lane owns 2 of
// the 64 dims, keeps its tokens' pos and dpos in registers and loops over the
// samples, so dpos needs no atomics and no second pass. Per sample, the 8
// warps merge their dq partial sums through shared memory and write them to
// a (tiles, B, 2, H, 64) f32 buffer that a second launch sums over tiles in
// a fixed order. Results do not vary from run to run.
#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int WARPS = 8;
constexpr int TOK = 8;                 // tokens per warp
constexpr int TILE = WARPS * TOK;      // tokens per block

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__global__ void __launch_bounds__(WARPS * 32)
decoder_attention_bwd_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ qc,
                             long long q_stride, const float* __restrict__ g0,
                             const float* __restrict__ stats, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                             const bf16* __restrict__ pos, float* __restrict__ dq_part,
                             float* __restrict__ dpos, int batch, int L, int heads, float scale) {
  __shared__ float sm[WARPS][2][D];

  const int tile = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * 2;
  const size_t tok_stride = (size_t)heads * D;
  const int l_base = tile * TILE + warp * TOK;

  float p0[TOK], p1[TOK], dp0[TOK], dp1[TOK];
#pragma unroll
  for (int u = 0; u < TOK; ++u) {
    const int l = l_base + u;
    p0[u] = p1[u] = dp0[u] = dp1[u] = 0.f;
    if (pos != nullptr && l < L) {
      const __nv_bfloat162 pp =
          *reinterpret_cast<const __nv_bfloat162*>(pos + l * tok_stride + h * D + d0);
      p0[u] = __low2float(pp);
      p1[u] = __high2float(pp);
    }
  }

  for (int b = 0; b < batch; ++b) {
    const __nv_bfloat162 qs2 =
        *reinterpret_cast<const __nv_bfloat162*>(qs + b * q_stride + h * D + d0);
    const __nv_bfloat162 qc2 =
        *reinterpret_cast<const __nv_bfloat162*>(qc + b * q_stride + h * D + d0);
    const float qs0 = __low2float(qs2), qs1 = __high2float(qs2);
    const float qc0 = __low2float(qc2), qc1 = __high2float(qc2);
    const float2 g = *reinterpret_cast<const float2*>(g0 + b * tok_stride + h * D + d0);
    const float mx = stats[((size_t)b * 3 + 0) * heads + h];
    const float inv_den = 1.0f / fmaxf(stats[((size_t)b * 3 + 1) * heads + h], 1e-30f);
    const float S = stats[((size_t)b * 3 + 2) * heads + h];

    const bf16* kb = k + (size_t)b * L * tok_stride + h * D + d0;
    const bf16* vb = v + (size_t)b * L * tok_stride + h * D + d0;
    const unsigned char* mb = mask + (size_t)b * L;

    float aqs0 = 0.f, aqs1 = 0.f, aqc0 = 0.f, aqc1 = 0.f;
#pragma unroll
    for (int u = 0; u < TOK; ++u) {
      const int l = l_base + u;
      const bool ok = l < L && mb[l] != 0;
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      if (ok) {
        const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(kb + l * tok_stride);
        const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(vb + l * tok_stride);
        k0 = __low2float(kk);
        k1 = __high2float(kk);
        v0 = __low2float(vv);
        v1 = __high2float(vv);
        if (pos != nullptr) {
          k0 += p0[u];
          k1 += p1[u];
          v0 += p0[u];
          v1 += p1[u];
        }
      }
      const float ls = warp_sum(qs0 * k0 + qs1 * k1) * scale;
      const float lc = warp_sum(qc0 * k0 + qc1 * k1) * scale;
      const float l1 = warp_sum(fabsf(qc0 - k0) + fabsf(qc1 - k1));
      const float w = warp_sum(g.x * v0 + g.y * v1);
      if (ok) {
        const float a_s = expf(ls - mx) * inv_den;
        const float t = tanhf(lc);
        const float gate = 2.0f / (1.0f + expf(l1 * scale));
        const float da = 0.5f * w;
        const float dls = a_s * (da - S);
        const float dlc = da * gate * (1.0f - t * t);
        const float du = -scale * (da * t) * gate * (1.0f - 0.5f * gate);
        const float s0 = sgn(qc0 - k0), s1 = sgn(qc1 - k1);
        aqs0 += dls * k0;
        aqs1 += dls * k1;
        aqc0 += scale * dlc * k0 + du * s0;
        aqc1 += scale * dlc * k1 + du * s1;
        if (pos != nullptr) {
          const float av = 0.5f * (a_s + t * gate);
          dp0[u] += dls * (qs0 * scale) + dlc * (qc0 * scale) - du * s0 + av * g.x;
          dp1[u] += dls * (qs1 * scale) + dlc * (qc1 * scale) - du * s1 + av * g.y;
        }
      }
    }

    sm[warp][0][d0] = aqs0;
    sm[warp][0][d0 + 1] = aqs1;
    sm[warp][1][d0] = aqc0;
    sm[warp][1][d0 + 1] = aqc1;
    __syncthreads();
    if (threadIdx.x < 2 * D) {
      const int r = threadIdx.x / D, d = threadIdx.x % D;
      float acc = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < WARPS; ++w2) acc += sm[w2][r][d];
      dq_part[(((size_t)tile * batch + b) * 2 + r) * tok_stride + h * D + d] =
          r == 0 ? scale * acc : acc;
    }
    __syncthreads();
  }

  if (dpos != nullptr) {
#pragma unroll
    for (int u = 0; u < TOK; ++u) {
      const int l = l_base + u;
      if (l < L)
        *reinterpret_cast<float2*>(dpos + l * tok_stride + h * D + d0) = make_float2(dp0[u], dp1[u]);
    }
  }
}

// dq[b, r, :] = sum over tiles of dq_part[tile, b, r, :], in tile order.
__global__ void decoder_attention_bwd_reduce(const float* __restrict__ dq_part,
                                             float* __restrict__ dq, int tiles, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t) acc += dq_part[(size_t)t * n + i];
  dq[i] = acc;
}

}  // namespace

// dq [B, 2, H * 64] f32 (rows dq_smax, dq_coda) and dpos [L, H, 64] f32 (or
// null when pos is null) from queries (row stride q_stride elements between
// samples, heads x 64 contiguous), g0 [B, H, 64] f32 (the output cotangent),
// stats [B, 3, H] f32 (rows max, denominator, S), K/V [B, L, H, 64] (already
// offset to the slot), mask [B, L] bytes and pos [L, H, 64] or null.
// dq_part is scratch of [ceil(L / 64), B, 2, H * 64] f32. The wrapper checks
// shapes.
extern "C" int dfd_decoder_attention_bwd(const void* qs, const void* qc, long long q_stride,
                                         const void* g0, const void* stats, const void* k,
                                         const void* v, const void* mask, const void* pos,
                                         void* dq_part, void* dq, void* dpos, int batch, int L,
                                         int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (L + TILE - 1) / TILE;
  decoder_attention_bwd_kernel<<<dim3(tiles, heads), WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(qc), q_stride,
      static_cast<const float*>(g0), static_cast<const float*>(stats),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(mask), static_cast<const bf16*>(pos),
      static_cast<float*>(dq_part), static_cast<float*>(dpos), batch, L, heads, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = batch * 2 * heads * D;
  decoder_attention_bwd_reduce<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(dq_part), static_cast<float*>(dq), tiles, n);
  return static_cast<int>(cudaGetLastError());
}
