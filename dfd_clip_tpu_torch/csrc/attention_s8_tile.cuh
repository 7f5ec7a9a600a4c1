// The int8 encoder attention's block bodies: _attn_int8_cols for one (frame,
// head) up to MAX_TOKENS (`tile`, staged), and for 128 query rows of one
// (frame, head) above (`stream_tile`). csrc/encoder_attention_s8.cu runs one
// work item per block; csrc/encoder_tower.cu walks a stage's items in a
// loop on its two consumer warpgroups. The bodies take the group of threads
// that runs them as a type (Block: the whole block; the tower's: its
// consumer warpgroups, with a named barrier), and each 16-row query tile's
// arithmetic is the same in either. The designs are described in
// encoder_attention_s8.cu.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace attn_s8 {

constexpr int D = 64;
constexpr int LDQ = D + 16;       // int8 pitch (bytes) of the quantised Q and K rows
constexpr int LDV = D + 8;        // bf16 pitch of the staged V rows
constexpr int MAX_TOKENS = 320;   // largest token count handled
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may use

// The threads that run a body: their index, their count and their barrier.
struct Block {
  static __device__ __forceinline__ int tid() { return threadIdx.x; }
  static __device__ __forceinline__ int size() { return blockDim.x; }
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) x b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// `limit`: the shared memory the caller can give (the tower keeps some for
// its barriers); fewer warps take the tiles when it is short, which changes
// no tile's values.
__host__ __device__ inline Geometry geometry(int tokens, size_t limit = SMEM_LIMIT) {
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
  while (g.warps > 1 && g.fixed + g.warps * g.per > limit) --g.warps;
  g.smem = g.fixed + g.warps * g.per;
  return g;
}

// Rows 0 .. 15 of one head (64 bf16 values at src + r * ld) quantised per
// (Q and K), s = max|x| + 1e-8, into dst (16 rows of
// LDQ bytes) and scale[16]; rows at or past `valid` are zero. Lanes 2r and
// 2r + 1 hold the halves of row r. One warp.
__device__ __forceinline__ void quant_rows16(const bf16* __restrict__ src, int ld, int valid,
                                             int8_t* dst, float* scale, int lane) {
  const int r = lane / 2, half = lane % 2;
  float v[32];
  if (r < valid) {
    const bf16* p = src + (size_t)r * ld + half * 32;
#pragma unroll
    for (int e = 0; e < 32; e += 8) load8(p + e, v + e);
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
  uint4* out = reinterpret_cast<uint4*>(dst + r * LDQ + half * 32);
  out[0] = pk.u[0];
  out[1] = pk.u[1];
  if (half == 0) scale[r] = s;
}

// Frame f's packed rows [q | k | v] start at qkv + f * tokens * ld; head h's
// 64 columns of each at + h * 64. out (frames * tokens, heads * 64) f32.
// coef_qk = d^-1/2 / 127^2 in f32. The group G computes (frame, head);
// warps from g.warps on only help quantise K and V. smem holds
// geometry(tokens, limit).smem.
template <int MAX_TP, bool QK_ONLY, class G = Block>
__device__ __forceinline__ void tile(const bf16* __restrict__ qkv, int ld, float* __restrict__ out,
                                     int tokens, int heads, float coef_qk, int frame, int head,
                                     unsigned char* smem, size_t limit = SMEM_LIMIT) {
  using namespace nvcuda;
  const Geometry g = geometry(tokens, limit);
  const int width = heads * D;
  const int nthreads = G::size(), nwarps = G::size() / 32;
  const int warp = G::tid() / 32, lane = G::tid() % 32;
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
  for (int c = G::tid(); c < g.tp * 8; c += nthreads) {
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
  G::sync();
  if (!QK_ONLY) {
    // V per channel over all tokens of the frame, stored transposed (V^T
    // rows are the PV product's k-contiguous B operand)
    for (int d = G::tid(); d < D; d += nthreads) {
      float m = 0.f;
      for (int r = 0; r < tokens; ++r) m = fmaxf(m, fabsf(__bfloat162float(Vs[r * LDV + d])));
      const float s = __fadd_rn(m, 1e-8f);
      sv[d] = s;
      svm[d] = 127.0f / s;
    }
    G::sync();
    for (int i = G::tid(); i < D * g.tp; i += nthreads) {
      const int d = i / g.tp, j = i % g.tp;
      Vt[d * g.ldt + j] = quant8(__bfloat162float(Vs[j * LDV + d]), svm[d]);
    }
    G::sync();
  }

  const int tiles = g.tq / 16;
  const int per_lane = g.tp / 32;
  for (int tl = warp; warp < g.warps && tl < tiles; tl += g.warps) {
    const int q0 = tl * 16;
    quant_rows16(qb + (size_t)q0 * ld, ld, tokens - q0, Qs, sq, lane);   // Q per row
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

// -- above MAX_TOKENS: the streamed body ---------------------------------------

constexpr int STREAM_WARPS = 8;                  // one 16-row query tile each
constexpr int STREAM_THREADS = 32 * STREAM_WARPS;
constexpr int STREAM_ROWS = 16 * STREAM_WARPS;   // query rows of a work item
constexpr int SEG = 256;                         // keys of a streamed segment
constexpr int LDT = SEG + 16;                    // int8 pitch of a segment's V^T rows
constexpr int PER_WARP = 16 * LDQ + 16 * 4;      // a warp's Q (int8) and sq

// Shared memory of stream_tile: a segment's K (int8) and sk, then its V
// (bf16, qk mode) or V^T (int8) with sv, 127 / sv and the partial channel
// maxima, then each warp's Q.
__host__ __device__ constexpr size_t stream_fixed(bool qk_only) {
  return (size_t)SEG * LDQ + SEG * 4 +
         (qk_only ? (size_t)SEG * LDV * 2
                  : (size_t)D * LDT + 2 * D * 4 + (size_t)(STREAM_THREADS / 8) * D * 4);
}

__host__ __device__ constexpr size_t stream_smem(bool qk_only) {
  return stream_fixed(qk_only) + (size_t)STREAM_WARPS * PER_WARP;
}

// Storage position of key k of a 16-key group in the V^T rows. The PV
// product takes P's A fragments straight from the logits' accumulator
// registers, where a thread holds keys 2t, 2t + 1, 8 + 2t, 9 + 2t of a
// 16-key group, while an m16n8k32 A fragment holds k indices 4t .. 4t + 3:
// the k index is permuted, and V^T stores its keys in the same permutation
// (the int32 sums are exact, so the order of k is free).
__device__ __forceinline__ int kpos(int k) {
  const int kk = k % 16;
  return (k & ~15) + (kk % 8) / 2 * 4 + (kk / 8) * 2 + kk % 2;
}

__device__ __forceinline__ unsigned pack_s8(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (unsigned)(uint8_t)a | (unsigned)(uint8_t)b << 8 | (unsigned)(uint8_t)c << 16 |
         (unsigned)(uint8_t)d << 24;
}

// Query rows chunk * 128 .. + 127 of (frame, head), layouts as in `tile`.
// A group G of STREAM_THREADS threads, smem holds stream_smem(QK_ONLY);
// every thread of the group calls it, also those of warps whose rows lie
// past the tokens (they help with the segments). The caller separates
// successive items with G::sync().
template <bool QK_ONLY, class G = Block>
__device__ __forceinline__ void stream_tile(const bf16* __restrict__ qkv, int ld,
                                            float* __restrict__ out, int tokens, int heads,
                                            float coef_qk, int frame, int head, int chunk,
                                            unsigned char* smem) {
  const int width = heads * D;
  const int tid = G::tid(), warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;   // mma fragment group and thread
  const int c8 = (tid % 8) * 8, rl = tid / 8;   // V: 8 channels a thread, 32 row lanes
  const bf16* qb = qkv + (size_t)frame * tokens * ld + head * D;
  const bf16* kb = qb + width;
  const bf16* vb = qb + 2 * width;

  int8_t* Ks = reinterpret_cast<int8_t*>(smem);
  float* sk = reinterpret_cast<float*>(smem + (size_t)SEG * LDQ);
  unsigned char* vbase = smem + (size_t)SEG * LDQ + SEG * 4;
  bf16* Vs = reinterpret_cast<bf16*>(vbase);       // qk mode: V rows, bf16
  int8_t* Vt = reinterpret_cast<int8_t*>(vbase);   // mode "1": V^T, int8, keys in kpos order
  float* sv = reinterpret_cast<float*>(vbase + (size_t)D * LDT);
  float* svm = sv + D;
  float* part = svm + D;                           // (32, D) partial channel maxima
  unsigned char* wbase = smem + stream_fixed(QK_ONLY) + (size_t)warp * PER_WARP;
  int8_t* Qs = reinterpret_cast<int8_t*>(wbase);
  float* sq = reinterpret_cast<float*>(wbase + 16 * LDQ);

  if (!QK_ONLY) {
    // V's scale per channel over all tokens of the frame
    float m[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) m[e] = 0.f;
#pragma unroll 4
    for (int r = rl; r < tokens; r += STREAM_THREADS / 8) {
      float v[8];
      load8(vb + (size_t)r * ld + c8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m[e] = fmaxf(m[e], fabsf(v[e]));
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) part[rl * D + c8 + e] = m[e];
    G::sync();
    if (tid < D) {
      float mx = 0.f;
      for (int i = 0; i < STREAM_THREADS / 8; ++i) mx = fmaxf(mx, part[i * D + tid]);
      const float s = __fadd_rn(mx, 1e-8f);
      sv[tid] = s;
      svm[tid] = 127.0f / s;
    }
  }

  const int q0 = (chunk * STREAM_WARPS + warp) * 16;
  const bool active = q0 < tokens;
  unsigned qa[2][4];
  float cq[2] = {0.f, 0.f};
  if (active) {
    quant_rows16(qb + (size_t)q0 * ld, ld, tokens - q0, Qs, sq, lane);
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int8_t* p = Qs + gq * LDQ + ks * 32 + t4 * 4;
      qa[ks][0] = *reinterpret_cast<const unsigned*>(p);
      qa[ks][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDQ);
      qa[ks][2] = *reinterpret_cast<const unsigned*>(p + 16);
      qa[ks][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDQ + 16);
    }
    cq[0] = __fmul_rn(sq[gq], coef_qk);
    cq[1] = __fmul_rn(sq[gq + 8], coef_qk);
  }

  // The segment's K rows quantised per row (pad rows zero). All threads.
  auto load_k = [&](int s0, int n) {
    for (int r0 = warp * 16; r0 < n; r0 += STREAM_ROWS)
      quant_rows16(kb + (size_t)(s0 + r0) * ld, ld, tokens - s0 - r0, Ks + r0 * LDQ, sk + r0,
                   lane);
  };
  // logits of the segment's keys n0 .. n0 + 7 (C fragment): (acc * (sq *
  // coef_qk)) * sk, as `tile` computes them; keys past the tokens are -inf
  auto logits = [&](int s0, int n0, float* l) {
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
      const int col = n0 + 2 * t4 + (e & 1);
      l[e] = s0 + col < tokens
          ? __fmul_rn(__fmul_rn(static_cast<float>(acc[e]), cq[e / 2]), sk[col])
          : -INFINITY;
    }
  };

  // pass 1: the row maxima (rows gq and gq + 8 of the warp's tile)
  float mrow[2] = {-INFINITY, -INFINITY};
  for (int s0 = 0; s0 < tokens; s0 += SEG) {
    const int n = min(SEG, (tokens - s0 + 31) / 32 * 32);
    G::sync();   // the previous segment is read
    load_k(s0, n);
    G::sync();
    if (active) {
      for (int n0 = 0; n0 < n; n0 += 8) {
        float l[4];
        logits(s0, n0, l);
        mrow[0] = fmaxf(mrow[0], fmaxf(l[0], l[1]));
        mrow[1] = fmaxf(mrow[1], fmaxf(l[2], l[3]));
      }
    }
  }
  mrow[0] = quad_max(mrow[0]);
  mrow[1] = quad_max(mrow[1]);

  // pass 2: the same logits, p = exp(l - max) (0 past the tokens), its row
  // sums and PV. P's per-row scale is max p + 1e-8, and max p is exp(0) = 1
  // (the row maximum's own entry), so P quantises as in `tile` without the
  // whole row at hand.
  const float sp = __fadd_rn(1.0f, 1e-8f), pmul = 127.0f / sp;
  float lsum[2] = {0.f, 0.f};
  int acc[D / 8][4];
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0;
      o[j][e] = 0.f;
    }
  for (int s0 = 0; s0 < tokens; s0 += SEG) {
    const int n = min(SEG, (tokens - s0 + 31) / 32 * 32);
    G::sync();
    if (QK_ONLY) {
      for (int c = tid; c < n * 8; c += STREAM_THREADS) {
        const int r = c / 8, cc = (c % 8) * 8;
        const bool ok = s0 + r < tokens;
        cp_async16(&Vs[r * LDV + cc], vb + (size_t)(ok ? s0 + r : 0) * ld + cc, ok);
      }
      cp_async_commit();
    }
    load_k(s0, n);
    if (QK_ONLY) {
      cp_async_wait<0>();
    } else {
      // V quantised per channel, transposed, keys in kpos order
#pragma unroll 4
      for (int r = rl; r < n; r += STREAM_THREADS / 8) {
        float v[8];
        if (s0 + r < tokens) {
          load8(vb + (size_t)(s0 + r) * ld + c8, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = 0.f;
        }
        const int at = kpos(r);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vt[(c8 + e) * LDT + at] = quant8(v[e], svm[c8 + e]);
      }
    }
    G::sync();
    if (!active) continue;
    for (int k0 = 0; k0 < n; k0 += 32) {
      float p[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        logits(s0, k0 + 8 * j, p[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = p[j][e] == -INFINITY ? 0.f : expf(p[j][e] - mrow[e / 2]);
          lsum[e / 2] += p[j][e];
        }
      }
      if (QK_ONLY) {
        // bf16(p) V, f32 accumulate (the streamed bf16 attention's fragments)
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          const unsigned pa[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                                  pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                                  pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                                  pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
          for (int dn = 0; dn < D / 8; dn += 2) {
            unsigned b[4];
            ldmatrix_x4_trans(
                b, &Vs[(k0 + kc * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDV + dn * 8 +
                       (lane / 16) * 8]);
            mma_bf16(o[dn], pa, b);
            mma_bf16(o[dn + 1], pa, b + 2);
          }
        }
      } else {
        // Pi Vi on the int8 tensor cores, P's fragments in kpos order
        int8_t q[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) q[j][e] = quant8(p[j][e], pmul);
        const unsigned pa[4] = {pack_s8(q[0][0], q[0][1], q[1][0], q[1][1]),
                                pack_s8(q[0][2], q[0][3], q[1][2], q[1][3]),
                                pack_s8(q[2][0], q[2][1], q[3][0], q[3][1]),
                                pack_s8(q[2][2], q[2][3], q[3][2], q[3][3])};
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int8_t* b = Vt + (j * 8 + gq) * LDT + k0 + t4 * 4;
          const unsigned vf[2] = {*reinterpret_cast<const unsigned*>(b),
                                  *reinterpret_cast<const unsigned*>(b + 16)};
          mma_s8(acc[j], pa, vf);
        }
      }
    }
  }
  if (!active) return;

  // qk: O * (1 / sum p); "1": (Pi Vi) * (sp / sum p / 127^2) * sv
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + gq + half * 8;
    const float rsum = 1.0f / quad_sum(lsum[half]);
    if (r >= tokens) continue;
    const float cr = QK_ONLY ? rsum : __fdiv_rn(__fmul_rn(sp, rsum), 16129.0f);
    float* dst = out + ((size_t)frame * tokens + r) * width + head * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + 2 * t4;
      float2 v;
      if (QK_ONLY) {
        v = make_float2(__fmul_rn(o[j][half * 2], cr), __fmul_rn(o[j][half * 2 + 1], cr));
      } else {
        v = make_float2(
            __fmul_rn(__fmul_rn(static_cast<float>(acc[j][half * 2]), cr), sv[d]),
            __fmul_rn(__fmul_rn(static_cast<float>(acc[j][half * 2 + 1]), cr), sv[d + 1]));
      }
      *reinterpret_cast<float2*>(dst + d) = v;
    }
  }
}

}  // namespace attn_s8
