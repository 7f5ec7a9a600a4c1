// The staged bf16 attention body of the whole-encoder tower, its only user
// (csrc/encoder_tower.cu walks a stage's (frame, head) pairs in a loop, up
// to MAX_TOKENS): softmax(q k^T d^-1/2) v of one (frame, head).
//
// K and V of the (frame, head) are staged once in shared memory (2 x tp x 72
// bf16 with row padding, tp the tokens rounded up to 16). Each warp then
// walks 16-query-row tiles: S = Q K^T via nvcuda::wmma into an f32 row
// buffer (16 x tp), a softmax with the row maximum subtracted whose
// unnormalised exp is rounded to bf16 over the rows of S already consumed,
// O = P V with f32 accumulate, and O x (1 / sum of the f32 exps) at the
// store: the rounding point of the TPU kernels and of csrc/encoder_attention.cu
// (which sums in another order, so the two agree to the ulp). Keys past the
// real rows are zero in shared memory and get probability 0. Up to 8 warps
// share a block, fewer where their logits buffers would not fit the 227 KB
// a block may use. The softmax's per-lane registers are sized at compile
// time, for 256 padded tokens (ViT-B's 197) or for 320.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace attn_bf16 {

constexpr int D = 64;
constexpr int LDK = D + 8;        // shared-memory row pitch (bf16) of Q, K, V
constexpr int MAX_TOKENS = 320;   // largest token count handled (a multiple of 16)
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may use

struct Geometry {
  int tp;        // tokens rounded up to 16
  int ldp;       // bf16 pitch of the probability rows
  int s_bytes;   // per-warp f32 logits buffer (also holds P and O staging)
  int warps;
  size_t smem;
};

__host__ __device__ inline Geometry geometry(int tokens) {
  Geometry g;
  g.tp = (tokens + 15) / 16 * 16;
  g.ldp = g.tp + 8;
  int s = 16 * g.tp * 4;
  int need = 16 * g.ldp * 2 + 16 * D * 4;   // P rows, then O staging
  g.s_bytes = ((s > need ? s : need) + 31) / 32 * 32;
  int tiles = g.tp / 16;
  int per_warp = (tiles + 7) / 8;
  g.warps = (tiles + per_warp - 1) / per_warp;
  const size_t kv = (size_t)2 * g.tp * LDK * 2, per = 16 * LDK * 2 + g.s_bytes;
  while (g.warps > 1 && kv + g.warps * per > SMEM_LIMIT) --g.warps;
  g.smem = kv + g.warps * per;
  return g;
}

// Row r of frame f, head h of x lies at x + (f * tokens + r) * ld + h * 64;
// tokens padded to 16 are at most MAX_TP.
// The block computes (frame, head); warps from g.warps on only help stage K
// and V (the tower's blocks have more warps than the geometry uses).
template <int MAX_TP, bool OUT_F32>
__device__ __forceinline__ void tile(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, int ld, void* __restrict__ out,
                                     int tokens, int heads, float scale, int frame, int head,
                                     unsigned char* smem) {
  using namespace nvcuda;
  const Geometry g = geometry(tokens);
  const int width = heads * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)frame * tokens * ld + head * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + g.tp * LDK;
  unsigned char* wbase = smem + (size_t)2 * g.tp * LDK * 2 + (size_t)warp * (16 * LDK * 2 + g.s_bytes);
  bf16* Qs = reinterpret_cast<bf16*>(wbase);
  float* S = reinterpret_cast<float*>(wbase + 16 * LDK * 2);
  bf16* P = reinterpret_cast<bf16*>(S);
  float* O = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(S) + 16 * g.ldp * 2);

  for (int c = threadIdx.x; c < g.tp * 8; c += blockDim.x) {
    const int r = c / 8, cc = (c % 8) * 8;
    const bool ok = r < tokens;
    const size_t at = (size_t)(ok ? r : 0) * ld + cc;
    cp_async16(&Ks[r * LDK + cc], kb + at, ok);
    cp_async16(&Vs[r * LDK + cc], vb + at, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int tiles = g.tp / 16;
  const int per_lane = (g.tp + 31) / 32;
  for (int tile = warp; warp < g.warps && tile < tiles; tile += g.warps) {
    const int q0 = tile * 16;
    for (int c = lane; c < 16 * 8; c += 32) {
      const int r = c / 8, cc = (c % 8) * 8;
      const bool ok = q0 + r < tokens;
      cp_async16(&Qs[r * LDK + cc], qb + (size_t)(ok ? q0 + r : 0) * ld + cc, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // S = Q K^T (16 x tp, f32)
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qa[kk], &Qs[kk * 16], LDK);
    for (int n = 0; n < tiles; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, &Ks[n * 16 * LDK + kk * 16], LDK);
        wmma::mma_sync(sc, qa[kk], kf, sc);
      }
      wmma::store_matrix_sync(&S[n * 16], sc, g.tp, wmma::mem_row_major);
    }
    __syncwarp();

    float rinv = 0.f;   // 1 / sum of row lane / 2
    // Row softmax. P row r (bf16, pitch ldp <= 2 tp) lies inside the bytes
    // of S rows <= r, which this warp has already read into registers.
    for (int r = 0; r < 16; ++r) {
      float x[MAX_TP / 32];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        const int c = lane + 32 * i;
        x[i] = (i < per_lane && c < tokens) ? S[r * g.tp + c] * scale : -INFINITY;
        m = fmaxf(m, x[i]);
      }
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        x[i] = (x[i] == -INFINITY) ? 0.f : expf(x[i] - m);
        s += x[i];
      }
      const float inv = 1.0f / warp_sum(s);
      if (r == lane / 2) rinv = inv;   // the store below writes row lane / 2
      __syncwarp();
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        const int c = lane + 32 * i;
        if (i < per_lane && c < g.tp) P[r * g.ldp + c] = __float2bfloat16(x[i]);
      }
    }
    __syncwarp();

    // O = P V (16 x 64, f32)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oc[j], 0.0f);
    for (int kt = 0; kt < tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, &P[kt * 16], g.ldp);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, &Vs[kt * 16 * LDK + j * 16], LDK);
        wmma::mma_sync(oc[j], pa, vf, oc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(&O[j * 16], oc[j], D, wmma::mem_row_major);
    __syncwarp();

    const int r = lane / 2, c0 = (lane % 2) * 32;
    if (q0 + r < tokens) {
      const size_t at = ((size_t)frame * tokens + q0 + r) * width + head * D + c0;
      if (OUT_F32) {
        float* dst = static_cast<float*>(out) + at;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 o = *reinterpret_cast<const float4*>(&O[r * D + c0 + e * 4]);
          *reinterpret_cast<float4*>(dst + e * 4) =
              make_float4(o.x * rinv, o.y * rinv, o.z * rinv, o.w * rinv);
        }
      } else {
        bf16* dst = static_cast<bf16*>(out) + at;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Pack8 p;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            p.h[i] = __float2bfloat16(O[r * D + c0 + e * 8 + i] * rinv);
          *reinterpret_cast<uint4*>(dst + e * 8) = p.u;
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace attn_bf16
