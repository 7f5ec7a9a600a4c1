// The int8 encoder attention's block body: _attn_int8_cols for one (frame,
// head). csrc/encoder_attention_s8.cu runs one (frame, head) per block;
// csrc/encoder_tower.cu walks a stage's (frame, head) pairs in a loop. The
// design is described in encoder_attention_s8.cu.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace attn_s8 {

constexpr int D = 64;
constexpr int LDQ = D + 16;       // int8 pitch (bytes) of the quantised Q and K rows
constexpr int LDV = D + 8;        // bf16 pitch of the staged V rows
constexpr int MAX_TOKENS = 320;   // largest token count handled
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may use

struct Geometry {
  int tq;        // query rows rounded up to 16 (one warp tile)
  int tp;        // key rows rounded up to 32 (the int8 PV product's k step)
  int ldt;       // int8 pitch of the V^T rows and of the int8 P rows
  int ldpb;      // bf16 pitch of the P rows (qk mode)
  int s_bytes;   // per-warp f32 logits buffer, also P and (qk) the O staging
  int warps;
  size_t fixed;  // V (bf16), V^T (int8), K (int8), sk, sv, 127 / sv
  size_t per;    // per warp: Q (int8), sq, the row coefficients, the logits buffer
  size_t smem;
};

__host__ __device__ inline Geometry geometry(int tokens) {
  Geometry g;
  g.tq = (tokens + 15) / 16 * 16;
  g.tp = (tokens + 31) / 32 * 32;
  g.ldt = g.tp + 16;
  g.ldpb = g.tp + 8;
  const int s = 16 * g.tp * 4;
  const int need = 16 * g.ldpb * 2 + 16 * D * 4;
  g.s_bytes = ((s > need ? s : need) + 31) / 32 * 32;
  g.fixed = (size_t)g.tp * LDV * 2 + (size_t)D * g.ldt + (size_t)g.tp * LDQ + (size_t)g.tp * 4 +
            2 * D * 4;
  g.per = 16 * LDQ + 2 * 16 * 4 + g.s_bytes;
  const int tiles = g.tq / 16;
  const int per_warp = (tiles + 7) / 8;
  g.warps = (tiles + per_warp - 1) / per_warp;
  while (g.warps > 1 && g.fixed + g.warps * g.per > SMEM_LIMIT) --g.warps;
  g.smem = g.fixed + g.warps * g.per;
  return g;
}

// Frame f's packed rows [q | k | v] start at qkv + f * tokens * ld; head h's
// 64 columns of each at + h * 64. out (frames * tokens, heads * 64) f32.
// coef_qk = d^-1/2 / 127^2 in f32. The block computes (frame, head); warps
// from g.warps on only help quantise K and V.
template <int MAX_TP, bool QK_ONLY>
__device__ __forceinline__ void tile(const bf16* __restrict__ qkv, int ld, float* __restrict__ out,
                                     int tokens, int heads, float coef_qk, int frame, int head,
                                     unsigned char* smem) {
  using namespace nvcuda;
  const Geometry g = geometry(tokens);
  const int width = heads * D;
  const int nthreads = blockDim.x, nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, t4 = lane % 4;   // mma fragment group and thread
  const bf16* qb = qkv + (size_t)frame * tokens * ld + head * D;
  const bf16* kb = qb + width;
  const bf16* vb = qb + 2 * width;

  bf16* Vs = reinterpret_cast<bf16*>(smem);
  int8_t* Vt = reinterpret_cast<int8_t*>(smem + (size_t)g.tp * LDV * 2);
  int8_t* Ks = Vt + (size_t)D * g.ldt;
  float* sk = reinterpret_cast<float*>(Ks + (size_t)g.tp * LDQ);
  float* sv = sk + g.tp;
  float* svm = sv + D;
  unsigned char* wbase = smem + g.fixed + (size_t)warp * g.per;
  int8_t* Qs = reinterpret_cast<int8_t*>(wbase);
  float* sq = reinterpret_cast<float*>(wbase + 16 * LDQ);
  float* coef = sq + 16;
  float* S = coef + 16;
  int8_t* Pi = reinterpret_cast<int8_t*>(S);
  bf16* Pb = reinterpret_cast<bf16*>(S);
  float* O = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(S) + 16 * g.ldpb * 2);

  // V rows (bf16) land in shared memory while the warps quantise K per row:
  // s = max|k| + 1e-8, q = clip(round(k * (127 / s))). Pad rows are zero.
  for (int c = threadIdx.x; c < g.tp * 8; c += nthreads) {
    const int r = c / 8, cc = (c % 8) * 8;
    const bool ok = r < tokens;
    cp_async16(&Vs[r * LDV + cc], vb + (size_t)(ok ? r : 0) * ld + cc, ok);
  }
  cp_async_commit();
  for (int r = warp; r < g.tp; r += nwarps) {
    float2 x = make_float2(0.f, 0.f);
    if (r < tokens)
      x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kb + (size_t)r * ld + 2 * lane));
    const float s = __fadd_rn(warp_max(fmaxf(fabsf(x.x), fabsf(x.y))), 1e-8f);
    const float mul = 127.0f / s;
    char2 qv;
    qv.x = quant8(x.x, mul);
    qv.y = quant8(x.y, mul);
    *reinterpret_cast<char2*>(Ks + r * LDQ + 2 * lane) = qv;
    if (lane == 0) sk[r] = s;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!QK_ONLY) {
    // V per channel over all tokens of the frame, stored transposed (V^T
    // rows are the PV product's k-contiguous B operand)
    for (int d = threadIdx.x; d < D; d += nthreads) {
      float m = 0.f;
      for (int r = 0; r < tokens; ++r) m = fmaxf(m, fabsf(__bfloat162float(Vs[r * LDV + d])));
      const float s = __fadd_rn(m, 1e-8f);
      sv[d] = s;
      svm[d] = 127.0f / s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < D * g.tp; i += nthreads) {
      const int d = i / g.tp, j = i % g.tp;
      Vt[d * g.ldt + j] = quant8(__bfloat162float(Vs[j * LDV + d]), svm[d]);
    }
    __syncthreads();
  }

  const int tiles = g.tq / 16;
  const int per_lane = g.tp / 32;
  for (int tl = warp; warp < g.warps && tl < tiles; tl += g.warps) {
    const int q0 = tl * 16;
    {  // Q per row: lanes 2r and 2r + 1 hold the two halves of row r
      const int r = lane / 2, half = lane % 2;
      float v[32];
      if (q0 + r < tokens) {
        const bf16* src = qb + (size_t)(q0 + r) * ld + half * 32;
#pragma unroll
        for (int e = 0; e < 32; e += 8) load8(src + e, v + e);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) v[e] = 0.f;
      }
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) m = fmaxf(m, fabsf(v[e]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      const float s = __fadd_rn(m, 1e-8f), mul = 127.0f / s;
      union {
        uint4 u[2];
        int8_t q[32];
      } pk;
#pragma unroll
      for (int e = 0; e < 32; ++e) pk.q[e] = quant8(v[e], mul);
      uint4* dst = reinterpret_cast<uint4*>(Qs + r * LDQ + half * 32);
      dst[0] = pk.u[0];
      dst[1] = pk.u[1];
      if (half == 0) sq[r] = s;
    }
    __syncwarp();

    // logits = (Qi Ki^T) * (sq * d^-1/2 / 127^2) * sk, int8 tensor cores,
    // exact int32 sums; key columns past the tokens are -inf
    unsigned qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int8_t* p = Qs + gq * LDQ + ks * 32 + t4 * 4;
      qa[ks][0] = *reinterpret_cast<const unsigned*>(p);
      qa[ks][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDQ);
      qa[ks][2] = *reinterpret_cast<const unsigned*>(p + 16);
      qa[ks][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDQ + 16);
    }
    const float cq0 = __fmul_rn(sq[gq], coef_qk), cq1 = __fmul_rn(sq[gq + 8], coef_qk);
    for (int n0 = 0; n0 < g.tp; n0 += 8) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int8_t* p = Ks + (n0 + gq) * LDQ + ks * 32 + t4 * 4;
        const unsigned kf[2] = {*reinterpret_cast<const unsigned*>(p),
                                *reinterpret_cast<const unsigned*>(p + 16)};
        mma_s8(acc, qa[ks], kf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gq + (e >= 2 ? 8 : 0), col = n0 + 2 * t4 + (e & 1);
        S[row * g.tp + col] = col < tokens
            ? __fmul_rn(__fmul_rn(static_cast<float>(acc[e]), e >= 2 ? cq1 : cq0), sk[col])
            : -INFINITY;
      }
    }
    __syncwarp();

    // Row softmax with the row maximum subtracted; P row r (int8 or bf16)
    // lies inside the bytes of S rows <= r, already read into registers.
    for (int r = 0; r < 16; ++r) {
      float x[MAX_TP / 32];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        x[i] = i < per_lane ? S[r * g.tp + lane + 32 * i] : -INFINITY;
        m = fmaxf(m, x[i]);
      }
      m = warp_max(m);
      float s = 0.f, pmax = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        x[i] = (x[i] == -INFINITY) ? 0.f : expf(x[i] - m);
        s += x[i];
        pmax = fmaxf(pmax, x[i]);
      }
      const float rsum = 1.0f / warp_sum(s);
      __syncwarp();
      if (QK_ONLY) {
#pragma unroll
        for (int i = 0; i < MAX_TP / 32; ++i)
          if (i < per_lane) Pb[r * g.ldpb + lane + 32 * i] = __float2bfloat16(x[i]);
        if (lane == 0) coef[r] = rsum;
      } else {
        // P per row: sp = max p + 1e-8, q = clip(round(p * (127 / sp)))
        const float sp = __fadd_rn(warp_max(pmax), 1e-8f), mul = 127.0f / sp;
#pragma unroll
        for (int i = 0; i < MAX_TP / 32; ++i)
          if (i < per_lane) Pi[r * g.ldt + lane + 32 * i] = quant8(x[i], mul);
        if (lane == 0) coef[r] = __fdiv_rn(__fmul_rn(sp, rsum), 16129.0f);
      }
    }
    __syncwarp();

    if (QK_ONLY) {
      // PV = bf16(p) V in bf16 with f32 accumulate, times 1 / sum p
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oc[j], 0.0f);
      for (int kt = 0; kt < g.tp / 16; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::load_matrix_sync(pa, &Pb[kt * 16], g.ldpb);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, &Vs[kt * 16 * LDV + j * 16], LDV);
          wmma::mma_sync(oc[j], pa, vf, oc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(&O[j * 16], oc[j], D, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 32;
      if (q0 + r < tokens) {
        float* dst = out + ((size_t)frame * tokens + q0 + r) * width + head * D + c0;
        const float cr = coef[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float4 o = *reinterpret_cast<const float4*>(&O[r * D + c0 + 4 * e]);
          o.x = __fmul_rn(o.x, cr);
          o.y = __fmul_rn(o.y, cr);
          o.z = __fmul_rn(o.z, cr);
          o.w = __fmul_rn(o.w, cr);
          *reinterpret_cast<float4*>(dst + 4 * e) = o;
        }
      }
    } else {
      // PV = (Pi Vi) * (sp / sum p / 127^2) * sv, int8 tensor cores
      int acc[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      for (int k0 = 0; k0 < g.tp; k0 += 32) {
        const int8_t* p = Pi + gq * g.ldt + k0 + t4 * 4;
        const unsigned pa[4] = {*reinterpret_cast<const unsigned*>(p),
                                *reinterpret_cast<const unsigned*>(p + 8 * g.ldt),
                                *reinterpret_cast<const unsigned*>(p + 16),
                                *reinterpret_cast<const unsigned*>(p + 8 * g.ldt + 16)};
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int8_t* b = Vt + (j * 8 + gq) * g.ldt + k0 + t4 * 4;
          const unsigned vf[2] = {*reinterpret_cast<const unsigned*>(b),
                                  *reinterpret_cast<const unsigned*>(b + 16)};
          mma_s8(acc[j], pa, vf);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = gq + half * 8;
        if (q0 + r >= tokens) continue;
        const float cr = coef[r];
        float* dst = out + ((size_t)frame * tokens + q0 + r) * width + head * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int d = j * 8 + 2 * t4;
          *reinterpret_cast<float2*>(dst + d) = make_float2(
              __fmul_rn(__fmul_rn(static_cast<float>(acc[j][half * 2]), cr), sv[d]),
              __fmul_rn(__fmul_rn(static_cast<float>(acc[j][half * 2 + 1]), cr), sv[d + 1]));
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace attn_s8
