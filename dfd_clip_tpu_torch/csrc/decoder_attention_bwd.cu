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
// The logits are recomputed by the forward kernel's own function
// (csrc/decoder_logits.cuh: k + pos in f32 from bf16 values, 8 lanes a
// token in the same lane layout and shuffle order), so exp(ls - max) with
// the saved max is the forward's value and stays <= 1. Masked and
// out-of-range tokens contribute exactly 0: a fully masked sample
// (denominator 0) gives dq = 0 and adds nothing to dpos.
//
// Bound on an H100: bytes. At the flagship train shape (12 samples, 12 heads,
// 4000 tokens, head_dim 64) a call reads ~147 MB of K/V for ~1 GFLOP.
//
// Design: dq is a sum over L per (sample, head) and dpos a sum over samples
// per (token, head), so the two reductions run in opposite directions. One
// block per (64-token tile, head), 8 warps of 8 tokens each, 4 at a time on
// the forward's lane layout (a lane owns 8 of a token's 64 dims): a lane
// keeps its two tokens' pos and dpos in registers and loops over the
// samples, so dpos needs no atomics and no second pass. Per sample, each
// warp adds its 4 token groups' dq partial sums by shuffles, the 8 warps
// merge them through shared memory and write them to a (tiles, B, 2, H,
// 64) f32 buffer that a second launch sums over tiles in a fixed order.
// Results do not vary from run to run.
#include "decoder_logits.cuh"

namespace {

using namespace dec;

constexpr int WARPS = 8;
constexpr int STEPS = 2;                  // steps of 4 tokens a warp
constexpr int TILE = WARPS * STEPS * TOKENS;   // tokens per block

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
  const int g = lane / GROUP, j = lane % GROUP;
  const size_t tok_stride = (size_t)heads * D;
  const size_t col = (size_t)h * D + j * DL;   // the lane's 8 dims of the head
  const int l_base = tile * TILE + warp * STEPS * TOKENS + g;   // + st * TOKENS

  float p[STEPS][DL], dp[STEPS][DL];
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int l = l_base + st * TOKENS;
#pragma unroll
    for (int e = 0; e < DL; ++e) p[st][e] = dp[st][e] = 0.f;
    if (pos != nullptr && l < L)
      unpack8(*reinterpret_cast<const uint4*>(pos + l * tok_stride + col), p[st]);
  }

  for (int b = 0; b < batch; ++b) {
    float q_s[DL], q_c[DL], gg[DL];
    unpack8(*reinterpret_cast<const uint4*>(qs + b * q_stride + col), q_s);
    unpack8(*reinterpret_cast<const uint4*>(qc + b * q_stride + col), q_c);
    const float4 ga = *reinterpret_cast<const float4*>(g0 + b * tok_stride + col);
    const float4 gb = *reinterpret_cast<const float4*>(g0 + b * tok_stride + col + 4);
    gg[0] = ga.x, gg[1] = ga.y, gg[2] = ga.z, gg[3] = ga.w;
    gg[4] = gb.x, gg[5] = gb.y, gg[6] = gb.z, gg[7] = gb.w;
    const float mx = stats[((size_t)b * 3 + 0) * heads + h];
    const float inv_den = 1.0f / fmaxf(stats[((size_t)b * 3 + 1) * heads + h], 1e-30f);
    const float S = stats[((size_t)b * 3 + 2) * heads + h];

    const bf16* kb = k + (size_t)b * L * tok_stride + col;
    const bf16* vb = v + (size_t)b * L * tok_stride + col;
    const unsigned char* mb = mask + (size_t)b * L;

    float aqs[DL], aqc[DL];
#pragma unroll
    for (int e = 0; e < DL; ++e) aqs[e] = aqc[e] = 0.f;
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int l = l_base + st * TOKENS;
      const bool ok = l < L && mb[l] != 0;
      float kk[DL], vv[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) kk[e] = vv[e] = 0.f;
      if (ok) {
        unpack8(*reinterpret_cast<const uint4*>(kb + l * tok_stride), kk);
        unpack8(*reinterpret_cast<const uint4*>(vb + l * tok_stride), vv);
      }
      const Logits lg = token_logits(q_s, q_c, kk, p[st], scale);   // kk is now k + pos
      float w = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        vv[e] = __fadd_rn(vv[e], p[st][e]);
        w += gg[e] * vv[e];
      }
      w = group_sum(w);
      if (ok) {
        const float a_s = expf(lg.ls - mx) * inv_den;
        const float t = tanhf(lg.lc);
        const float gate = 2.0f / (1.0f + expf(lg.l1 * scale));
        const float da = 0.5f * w;
        const float dls = a_s * (da - S);
        const float dlc = da * gate * (1.0f - t * t);
        const float du = -scale * (da * t) * gate * (1.0f - 0.5f * gate);
        const float av = 0.5f * (a_s + t * gate);
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          const float sg = sgn(q_c[e] - kk[e]);
          aqs[e] += dls * kk[e];
          aqc[e] += scale * dlc * kk[e] + du * sg;
          if (pos != nullptr)
            dp[st][e] += dls * (q_s[e] * scale) + dlc * (q_c[e] * scale) - du * sg + av * gg[e];
        }
      }
    }
    // the warp's 4 token groups, then its 8 warps
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      aqs[e] += __shfl_xor_sync(0xffffffffu, aqs[e], 8);
      aqs[e] += __shfl_xor_sync(0xffffffffu, aqs[e], 16);
      aqc[e] += __shfl_xor_sync(0xffffffffu, aqc[e], 8);
      aqc[e] += __shfl_xor_sync(0xffffffffu, aqc[e], 16);
    }
    if (lane < GROUP) {
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        sm[warp][0][j * DL + e] = aqs[e];
        sm[warp][1][j * DL + e] = aqc[e];
      }
    }
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
    for (int st = 0; st < STEPS; ++st) {
      const int l = l_base + st * TOKENS;
      if (l < L) {
        float4* o = reinterpret_cast<float4*>(dpos + l * tok_stride + col);
        o[0] = make_float4(dp[st][0], dp[st][1], dp[st][2], dp[st][3]);
        o[1] = make_float4(dp[st][4], dp[st][5], dp[st][6], dp[st][7]);
      }
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
