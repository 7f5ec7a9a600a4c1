// Backward of the single-query dual-activation decoder attention, for the
// trainable leaves: dq_smax, dq_coda and the temporal positional embedding's
// cotangent dpos, and, when K and V are live (an adapter before the
// decoder), dK and dV, in one launch over K and V.
//
// Replaces: dfd_clip_tpu/ops/pallas_decoder_attention.py
// fused_decoder_attention_bwd (_bwd_kernel), and the XLA dK/dV einsums
// beside it (dfd_clip_tpu/ops/decoder_attention_vjp.py:180-201). Math of
// ops/decoder_attention_vjp._bwd_math: per valid token, with kp = k + pos,
// vp = v + pos and the forward's saved softmax state (max, denominator),
//   a_s = exp(ls - max) / denom, t = tanh(lc), g = 2 sigmoid(-|qc - kp|_1 s)
//   da = 0.5 g0 . vp
//   dls = a_s (da - S)        S = 0.5 sum_d g0 o_s
//   dlc = da g (1 - t^2),  du = -s da t g (1 - g / 2)
//   dq_smax = s sum_l dls kp,  dq_coda = s sum_l dlc kp + sum_l du sign(qc - kp)
//   dk[b, l] = dls qs s + dlc qc s - du sign(qc - kp)
//   dv[b, l] = 0.5 (a_s + t g) g0
//   dpos[l] = sum_b dk[b, l] + dv[b, l]
// S removes the global softmax coupling term, so a single pass suffices.
// The logits are recomputed by the forward kernel's own function
// (csrc/decoder_logits.cuh: k + pos in f32 from bf16 values, 8 lanes a
// token in the same lane layout and shuffle order), so exp(ls - max) with
// the saved max is the forward's value and stays <= 1. Masked and
// out-of-range tokens contribute exactly 0: a fully masked sample
// (denominator 0) gives dq = 0 and adds nothing to dpos.
//
// Bound on an H100: bytes. At the train shape (12 samples, 12 heads, 4000
// tokens, head_dim 64) a call reads ~126 MB of valid K/V rows for ~0.85
// GFLOP (0.043 ms at 3.35 TB/s); with dK/dV it also writes two bf16 (B, L,
// H, 64) tensors, as many bytes again as the K/V it reads (at the adapter's
// unpadded 12 x 3,920 tokens ~144.5 MB more).
//
// Design: dq is a sum over L per (sample, head) and dpos a sum over samples
// per (token, head), so the two reductions run in opposite directions.
// - Work items: L is cut into tiles of TILE = 96 tokens and the tiles into
//   chunks (ops/_cuda.py bwd_geometry sizes them so that heads x chunks
//   fill the SMs in about one wave); an item is one (head, chunk), heads
//   fastest, and a persistent grid of one block a SM walks the items.
// - Loads: one producer warp reads each (sample, tile)'s mask bytes (one
//   pair ahead), issues no load for a pair whose tokens are all masked,
//   and otherwise moves its K and V boxes (64 dims of the head x 96 tokens)
//   by TMA through 3-D tensor maps over (H x 64, L, B) at the slot, into a
//   ring of STAGES stages on mbarriers, so later samples load while one
//   computes. Each stage carries a header (sample, tile, the tile's valid
//   bits), so the consumers follow the producer's schedule without reading
//   the mask themselves; an end marker closes each pass. The pos tile of a
//   tile goes by TMA into one of two buffers the first time a live stage
//   of that tile comes.
// - Consumers: 12 warps, 8 tokens each of a tile (2 steps of 4 tokens on
//   the forward's lane layout: a lane owns 8 of a token's 64 dims), copy
//   their rows to registers and release the stage before any arithmetic. A
//   warp with no valid token in the stage skips it. pos and dpos of the
//   warp's tokens stay in registers over every sample of the tile, so dpos
//   needs no atomics: when the tile changes the warp stores it (tiles with
//   no live stage get zeros).
// - dq without a barrier a sample: after each stage a warp reduces its 4
//   token groups' dq sums by a reduce-scatter (xor 16, then 8: each lane
//   ends with 4 of the 128 values) and adds them into its own shared-memory
//   partials of that sample. At the end of an item the consumers merge the
//   12 warps' partials in warp order into the chunk's (B, 2, H x 64) f32
//   slice of dq_part; the last block of a head to finish (an atomic ticket
//   per head, which it resets to 0 for the next launch) adds the chunks in
//   chunk order and writes dq, f32 or bf16. Results do not vary from run to
//   run.
// - The weights use the fast exponential and division (__expf,
//   __fdividef): the kernel is issue-bound, and the accurate functions cost
//   12-17 % of its time. tanh' = 1 - tanh^2 is taken as sech^2 = 4 e r^2
//   (e = exp(2 lc), r = 1 / (1 + e)), which has no cancellation where tanh
//   saturates; an approximate tanh in 1 - t^2 (tanh.approx, ~5e-4) moved a
//   train step's gradients past their hold there.
// - The per-sample values (the queries, g0 = ct in f32, the saved maximum,
//   1 / denominator and S = 0.5 g0 . o_s) are computed by the consumers
//   into shared memory at the start of an item, so the wrapper does no
//   arithmetic. A batch whose partials do not fit goes in passes of
//   `group` samples; a pass after the first adds its dpos to the stored
//   values (the block owns those tokens, so the order is fixed).
// - dK/dV: each consumer lane has its 8 dims of a token's dk and dv (the
//   terms it folds into dpos) and stores them as one 16-byte bf16 word
//   each, so a token's 8 lanes write its 128-byte row; every (sample,
//   token, head) is written once and needs no atomics. Masked tokens get
//   zeros: the consumers write them for the tokens of a live stage, the
//   producer warp for a (sample, tile) whose tokens are all masked, which
//   it moves no data for.
#include "decoder_logits.cuh"
#include "hopper.cuh"

namespace {

using namespace dec;
using namespace hopper;

constexpr int WARPS = 12;                           // consumer warps
constexpr int STEPS = 2;                            // steps of 4 tokens a warp and stage
constexpr int WTOK = STEPS * TOKENS;                // a warp's tokens of a tile
constexpr int TILE = WARPS * WTOK;                  // tokens a tile (ops/_cuda.py BWD_TILE)
constexpr int THREADS = 32 * (WARPS + 1);           // and the producer warp
constexpr int STAGES = 4;                           // ring stages (ops/_cuda.py BWD_STAGES)
constexpr int TILE_BYTES = TILE * D * 2;            // one K, V or pos box
constexpr int STAGE_BYTES = 2 * TILE_BYTES;         // K then V
constexpr int MASK_WORDS = TILE / 32;
constexpr int HEADER_BYTES = 32;                    // sample, tile, the valid bits
constexpr int SAMPLE_FLOATS = 3 * D + 4;            // qs, qc, g0, {max, 1 / denom, S, pad}
constexpr int PART_FLOATS = 2 * D;                  // a warp's dq partials of a sample
static_assert(TILE % 32 == 0 && WTOK % 8 == 0 && (WTOK * WARPS) % 32 == 0, "tile layout");
static_assert(4 * MASK_WORDS + 8 <= HEADER_BYTES, "header");

// Shared-memory layout (ops/_cuda.py bwd_geometry mirrors it): the ring, two
// pos buffers, the stage headers, the barriers and the ticket flag, then
// `group` samples' values and the warps' dq partials.
constexpr int RING_OFF = 0;
constexpr int POS_OFF = RING_OFF + STAGES * STAGE_BYTES;
constexpr int HEAD_OFF = POS_OFF + 2 * TILE_BYTES;
constexpr int BAR_OFF = HEAD_OFF + STAGES * HEADER_BYTES;
constexpr int BARS = 2 * STAGES + 4;                // full, empty; pos full, pos empty
constexpr int FLAG_OFF = BAR_OFF + 8 * BARS;
constexpr int TABLE_OFF = (FLAG_OFF + 16 + 127) / 128 * 128;
constexpr int ALIGN = 128;

struct Header {
  int b, tile;
  unsigned bits[MASK_WORDS];
};

struct Args {
  const bf16* qs;
  const bf16* qc;
  long long q_stride;            // elements between samples' query rows
  const void* ct;                // (B, H, 64), f32 when ct_f32 else bf16
  const float* o_s;              // (B, H, 64) f32
  const float* denom;            // (B, H) rows stat_stride apart
  const float* mx;
  long long stat_stride;
  const unsigned char* mask;     // (B, L)
  float* dq_part;                // [chunks][B][2][H x 64] f32
  void* dq;                      // [B][2][H x 64], f32 when dq_f32 else bf16
  float* dpos;                   // (L, H, 64) f32, or null without pos
  bf16* dk;                      // (B, L, H, 64) bf16, or null: no dK/dV
  bf16* dv;
  int* ticket;                   // [H] zeroed, left zeroed
  long long* clock;              // the stage clock: CLOCKS a block, or null
  int ct_f32, dq_f32, has_pos;
  int batch, L, heads, tiles, chunk_tiles, chunks, group;
  float scale;
};

// The stage clock (ops/_cuda.py BWD_CLOCK): %globaltimer at these points of
// each block's first item, read by tools/bench_decoder_bwd.py.
constexpr int CLOCKS = 7;
enum Clock : int { kStart, kTable, kFirstStage, kIssued, kStreamed, kMerged, kDone };

__device__ __forceinline__ void stamp(const Args& a, int item, int which) {
  if (a.clock != nullptr && item == (int)blockIdx.x) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    a.clock[(size_t)blockIdx.x * CLOCKS + which] = t;
  }
}

// du sign(x), with sign(0) = 0: du with its sign bit flipped where x < 0.
__device__ __forceinline__ float signed_du(float du, float x) {
  const float f = __int_as_float(__float_as_int(du) ^ (__float_as_int(x) & 0x80000000));
  return x == 0.f ? 0.f : f;
}


// This (sample, tile)'s valid bits, one word per 32 tokens (warp-wide).
__device__ __forceinline__ void tile_bits(const Args& a, int b, int t, int lane,
                                          unsigned (&bits)[MASK_WORDS]) {
  const unsigned char* mb = a.mask + (size_t)b * a.L;
  bool v[MASK_WORDS];
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) {
    const int tok = t * TILE + 32 * w + lane;
    v[w] = tok < a.L && mb[tok] != 0;
  }
#pragma unroll
  for (int w = 0; w < MASK_WORDS; ++w) bits[w] = __ballot_sync(0xffffffffu, v[w]);
}

struct Smem {
  unsigned char* base;
  uint32_t sbase;
  __device__ uint32_t ring(int s) const { return sbase + RING_OFF + s * STAGE_BYTES; }
  __device__ const unsigned char* ring_ptr(int s) const { return base + RING_OFF + s * STAGE_BYTES; }
  __device__ uint32_t pos(int p) const { return sbase + POS_OFF + p * TILE_BYTES; }
  __device__ const unsigned char* pos_ptr(int p) const { return base + POS_OFF + p * TILE_BYTES; }
  __device__ Header* header(int s) const {
    return reinterpret_cast<Header*>(base + HEAD_OFF + s * HEADER_BYTES);
  }
  __device__ uint32_t full(int s) const { return sbase + BAR_OFF + 8u * s; }
  __device__ uint32_t empty(int s) const { return sbase + BAR_OFF + 8u * (STAGES + s); }
  __device__ uint32_t pos_full(int p) const { return sbase + BAR_OFF + 8u * (2 * STAGES + p); }
  __device__ uint32_t pos_empty(int p) const {
    return sbase + BAR_OFF + 8u * (2 * STAGES + 2 + p);
  }
  __device__ int* flag() const { return reinterpret_cast<int*>(base + FLAG_OFF); }
  __device__ float* table(int bb) const {
    return reinterpret_cast<float*>(base + TABLE_OFF) + bb * SAMPLE_FLOATS;
  }
  __device__ float* part(int group, int w, int bb) const {
    return reinterpret_cast<float*>(base + TABLE_OFF) + group * SAMPLE_FLOATS +
           ((size_t)w * group + bb) * PART_FLOATS;
  }
};

// dK/dV of (sample b, tile t, head h) set to zeros by one warp: 8 lanes a
// token's 128-byte row.
__device__ __forceinline__ void zero_kv_tile(const Args& a, int b, int t, int h, int lane) {
  const size_t hd_cols = (size_t)a.heads * D;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = lane; i < TILE * GROUP; i += 32) {
    const int l = t * TILE + i / GROUP;
    if (l >= a.L) break;
    const size_t at = ((size_t)b * a.L + l) * hd_cols + h * D + (i % GROUP) * DL;
    *reinterpret_cast<uint4*>(a.dk + at) = z;
    *reinterpret_cast<uint4*>(a.dv + at) = z;
  }
}

// ---- the producer warp ------------------------------------------------------------------
__device__ __forceinline__ void produce(const Smem& sm, const Args& a, const CUtensorMap* mk,
                                        const CUtensorMap* mv, const CUtensorMap* mp, int lane) {
  const int items = a.heads * a.chunks;
  int n = 0, npos = 0;   // stages and pos tiles issued (warp-uniform)
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int h = item % a.heads, c = item / a.heads;
    const int t0 = c * a.chunk_tiles, t1 = min(a.tiles, t0 + a.chunk_tiles);
    for (int b0 = 0; b0 < a.batch; b0 += a.group) {
      const int b1 = min(a.batch, b0 + a.group), nb = b1 - b0;
      // (tile, sample) pairs in order, each pair's mask read one ahead
      unsigned ahead[MASK_WORDS];
      tile_bits(a, b0, t0, lane, ahead);
      int last_tile = -1;
      for (int i = 0, total = (t1 - t0) * nb; i < total; ++i) {
        const int t = t0 + i / nb, b = b0 + i % nb;
        unsigned bits[MASK_WORDS];
#pragma unroll
        for (int w = 0; w < MASK_WORDS; ++w) bits[w] = ahead[w];
        if (i + 1 < total) tile_bits(a, b0 + (i + 1) % nb, t0 + (i + 1) / nb, lane, ahead);
        unsigned any = 0;
#pragma unroll
        for (int w = 0; w < MASK_WORDS; ++w) any |= bits[w];
        if (any == 0) {   // every token masked: no load, no stage; zero dK/dV
          if (a.dk != nullptr) zero_kv_tile(a, b, t, h, lane);
          continue;
        }
        if (a.has_pos && t != last_tile) {
          const int p = npos & 1;
          if (lane == 0) {
            mbar_wait(sm.pos_empty(p), ((npos >> 1) & 1) ^ 1);
            mbar_expect_tx(sm.pos_full(p), TILE_BYTES);
            tma_load(sm.pos(p), mp, sm.pos_full(p), h * D, t * TILE);
          }
          ++npos;
        }
        last_tile = t;
        const int s = n % STAGES;
        if (lane == 0) {
          mbar_wait(sm.empty(s), ((n / STAGES) & 1) ^ 1);
          Header* hd = sm.header(s);
          hd->b = b;
          hd->tile = t;
#pragma unroll
          for (int w = 0; w < MASK_WORDS; ++w) hd->bits[w] = bits[w];
          mbar_expect_tx(sm.full(s), STAGE_BYTES);
          tma_load(sm.ring(s), mk, sm.full(s), h * D, t * TILE, b);
          tma_load(sm.ring(s) + TILE_BYTES, mv, sm.full(s), h * D, t * TILE, b);
        }
        ++n;
        __syncwarp();
      }
      // the pass's end marker
      const int s = n % STAGES;
      if (lane == 0 && b0 + a.group >= a.batch) stamp(a, item, kIssued);
      if (lane == 0) {
        mbar_wait(sm.empty(s), ((n / STAGES) & 1) ^ 1);
        sm.header(s)->b = -1;
        mbar_arrive(sm.full(s));
      }
      ++n;
      __syncwarp();
    }
  }
}

// ---- the consumer warps -----------------------------------------------------------------
// The warp's tokens of tile t: l = t * TILE + cw * WTOK + st * TOKENS + g.
__device__ __forceinline__ void store_dpos(const Args& a, int t, int cw, int g, int col,
                                           const float (&dp)[STEPS][DL], bool add) {
  const size_t tok_stride = (size_t)a.heads * D;
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int l = t * TILE + cw * WTOK + st * TOKENS + g;
    if (l >= a.L) continue;
    float4* o = reinterpret_cast<float4*>(a.dpos + l * tok_stride + col);
    float4 x = make_float4(dp[st][0], dp[st][1], dp[st][2], dp[st][3]);
    float4 y = make_float4(dp[st][4], dp[st][5], dp[st][6], dp[st][7]);
    if (add) {
      const float4 u = o[0], w = o[1];
      x = make_float4(u.x + x.x, u.y + x.y, u.z + x.z, u.w + x.w);
      y = make_float4(w.x + y.x, w.y + y.y, w.z + y.z, w.w + y.w);
    }
    o[0] = x;
    o[1] = y;
  }
}

__device__ __forceinline__ void consume(const Smem& sm, const Args& a, int cw, int lane) {
  const int ct = threadIdx.x - 32;                  // 0 .. 32 WARPS - 1
  const int g = lane / GROUP, j = lane % GROUP;
  const size_t hd_cols = (size_t)a.heads * D;
  const int items = a.heads * a.chunks;
  const float scale = a.scale;
  const float zero[STEPS][DL] = {};
  int n = 0, npos = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int h = item % a.heads, c = item / a.heads;
    const int t0 = c * a.chunk_tiles, t1 = min(a.tiles, t0 + a.chunk_tiles);
    const int col = h * D + j * DL;   // the lane's 8 dims of the head
    for (int b0 = 0; b0 < a.batch; b0 += a.group) {
      const int nb = min(a.batch, b0 + a.group) - b0;
      const bool first_pass = b0 == 0;
      // ---- the pass's per-sample values; this warp's partials zeroed
      for (int bb = cw; bb < nb; bb += WARPS) {
        const int b = b0 + bb;
        float* tb = sm.table(bb);
        const size_t qa = (size_t)b * a.q_stride + h * D;
        const size_t ga = ((size_t)b * a.heads + h) * D;
        float s_part = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int d = lane + 32 * k;
          tb[d] = __bfloat162float(a.qs[qa + d]);
          tb[D + d] = __bfloat162float(a.qc[qa + d]);
          const float g0 = a.ct_f32 ? static_cast<const float*>(a.ct)[ga + d]
                                    : __bfloat162float(static_cast<const bf16*>(a.ct)[ga + d]);
          tb[2 * D + d] = g0;
          s_part += g0 * a.o_s[ga + d];
        }
        s_part = warp_sum(s_part);
        if (lane == 0) {
          const size_t sa = (size_t)b * a.stat_stride + h;
          tb[3 * D] = a.mx[sa];
          tb[3 * D + 1] = 1.0f / fmaxf(a.denom[sa], 1e-30f);
          tb[3 * D + 2] = 0.5f * s_part;
          tb[3 * D + 3] = 0.f;
        }
      }
      for (int bb = 0; bb < nb; ++bb) {
        float4* pw = reinterpret_cast<float4*>(sm.part(a.group, cw, bb));
        pw[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      named_barrier(1, 32 * WARPS);
      if (ct == 0 && first_pass) stamp(a, item, kTable);

      // ---- the pass's stages
      float p[STEPS][DL], dp[STEPS][DL];
      int cur = -1, written = t0;   // the tile in registers; tiles below `written` are stored
      for (bool seen = false;; seen = true) {
        const int s = n % STAGES;
        mbar_wait(sm.full(s), (n / STAGES) & 1);
        if (ct == 0 && first_pass && !seen) stamp(a, item, kFirstStage);
        const Header* hd = sm.header(s);
        const int b = hd->b;
        if (b < 0) {
          warp_arrive(sm.empty(s));
          ++n;
          break;
        }
        const int t = hd->tile;
        const unsigned mine =
            (hd->bits[(cw * WTOK) / 32] >> ((cw * WTOK) % 32)) & ((1u << WTOK) - 1u);
        if (t != cur) {
          if (a.dpos != nullptr) {
            if (cur >= 0) store_dpos(a, cur, cw, g, col, dp, !first_pass);
            if (first_pass)
              for (int z = written; z < t; ++z) store_dpos(a, z, cw, g, col, zero, false);
          }
          cur = t;
          written = t + 1;
#pragma unroll
          for (int st = 0; st < STEPS; ++st)
#pragma unroll
            for (int e = 0; e < DL; ++e) p[st][e] = dp[st][e] = 0.f;
          if (a.has_pos) {
            const int pb = npos & 1;
            mbar_wait(sm.pos_full(pb), (npos >> 1) & 1);
            const unsigned char* pt = sm.pos_ptr(pb);
#pragma unroll
            for (int st = 0; st < STEPS; ++st)
              unpack8(*reinterpret_cast<const uint4*>(
                          pt + (cw * WTOK + st * TOKENS + g) * (D * 2) + j * 16),
                      p[st]);
            warp_arrive(sm.pos_empty(pb));
            ++npos;
          }
        }
        if (mine == 0) {   // none of the warp's tokens is valid in this sample
          warp_arrive(sm.empty(s));
          ++n;
          if (a.dk != nullptr) {
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int st = 0; st < STEPS; ++st) {
              const int l = t * TILE + cw * WTOK + st * TOKENS + g;
              if (l >= a.L) continue;
              const size_t at = ((size_t)b * a.L + l) * hd_cols + col;
              *reinterpret_cast<uint4*>(a.dk + at) = z;
              *reinterpret_cast<uint4*>(a.dv + at) = z;
            }
          }
          continue;
        }
        uint4 kr[STEPS], vr[STEPS];
        const unsigned char* kt = sm.ring_ptr(s);
#pragma unroll
        for (int st = 0; st < STEPS; ++st) {
          const int off = (cw * WTOK + st * TOKENS + g) * (D * 2) + j * 16;
          kr[st] = *reinterpret_cast<const uint4*>(kt + off);
          vr[st] = *reinterpret_cast<const uint4*>(kt + TILE_BYTES + off);
        }
        warp_arrive(sm.empty(s));
        ++n;

        const float* tb = sm.table(b - b0);
        float q_s[DL], q_c[DL], gg[DL];
#pragma unroll
        for (int e = 0; e < DL; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(tb + j * DL + e);
          const float4 y = *reinterpret_cast<const float4*>(tb + D + j * DL + e);
          const float4 z = *reinterpret_cast<const float4*>(tb + 2 * D + j * DL + e);
          q_s[e] = x.x, q_s[e + 1] = x.y, q_s[e + 2] = x.z, q_s[e + 3] = x.w;
          q_c[e] = y.x, q_c[e + 1] = y.y, q_c[e + 2] = y.z, q_c[e + 3] = y.w;
          gg[e] = z.x, gg[e + 1] = z.y, gg[e + 2] = z.z, gg[e + 3] = z.w;
        }
        const float4 stat = *reinterpret_cast<const float4*>(tb + 3 * D);
        const float mx = stat.x, inv_den = stat.y, S = stat.z;

        float aqs[DL], aqc[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) aqs[e] = aqc[e] = 0.f;
#pragma unroll
        for (int st = 0; st < STEPS; ++st) {
          const bool ok = (mine >> (st * TOKENS + g)) & 1u;
          float kk[DL], vv[DL];
          unpack8(kr[st], kk);
          unpack8(vr[st], vv);
          const Logits lg = token_logits(q_s, q_c, kk, p[st], scale);   // kk is now k + pos
          float w = 0.f;
#pragma unroll
          for (int e = 0; e < DL; ++e) {
            vv[e] = __fadd_rn(vv[e], p[st][e]);
            w += gg[e] * vv[e];
          }
          w = group_sum(w);
          float dke[DL], dve[DL];
#pragma unroll
          for (int e = 0; e < DL; ++e) dke[e] = dve[e] = 0.f;
          if (ok) {
            const float a_s = __expf(lg.ls - mx) * inv_den;
            // tanh and 1 - tanh^2 = sech^2 from e = exp(2 lc): r = 1 / (1 + e),
            // t = 1 - 2 r, sech^2 = 4 e r^2, with no difference of near-equal
            // values even where tanh saturates (|lc| = 15 is past f32's +-1)
            const float e2 = __expf(2.0f * fminf(fmaxf(lg.lc, -15.0f), 15.0f));
            const float r = __fdividef(1.0f, 1.0f + e2);
            const float th = 1.0f - 2.0f * r;
            const float sech2 = 4.0f * r * (e2 * r);
            const float gate = __fdividef(2.0f, 1.0f + __expf(lg.l1 * scale));
            const float da = 0.5f * w;
            const float dls = a_s * (da - S);
            const float dlc = da * gate * sech2;
            const float du = -scale * (da * th) * gate * (1.0f - 0.5f * gate);
            const float av = 0.5f * (a_s + th * gate);
            const float sdls = scale * dls, sdlc = scale * dlc;
#pragma unroll
            for (int e = 0; e < DL; ++e) {
              const float dsg = signed_du(du, __fsub_rn(q_c[e], kk[e]));
              aqs[e] += dls * kk[e];
              aqc[e] += sdlc * kk[e] + dsg;
              dke[e] = sdls * q_s[e] + sdlc * q_c[e] - dsg;
              dve[e] = av * gg[e];
              dp[st][e] += dke[e] + dve[e];
            }
          }
          const int l = t * TILE + cw * WTOK + st * TOKENS + g;
          if (a.dk != nullptr && l < a.L) {   // zeros for a masked token
            const size_t at = ((size_t)b * a.L + l) * hd_cols + col;
            *reinterpret_cast<uint4*>(a.dk + at) =
                make_uint4(pack_bf16(dke[0], dke[1]), pack_bf16(dke[2], dke[3]),
                           pack_bf16(dke[4], dke[5]), pack_bf16(dke[6], dke[7]));
            *reinterpret_cast<uint4*>(a.dv + at) =
                make_uint4(pack_bf16(dve[0], dve[1]), pack_bf16(dve[2], dve[3]),
                           pack_bf16(dve[4], dve[5]), pack_bf16(dve[6], dve[7]));
          }
        }
        // the 4 token groups' sums, scattered: lane (g, j) keeps 4 of the 128
        // values (g bit 1: smax / coda; g bit 0: dims j 8 + 0..3 / 4..7)
        const bool lo = (g & 2) == 0, ev = (g & 1) == 0;
        float r[DL], u[4];
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          const float send = lo ? aqc[e] : aqs[e];
          r[e] = (lo ? aqs[e] : aqc[e]) + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = ev ? r[e + 4] : r[e];
          u[e] = (ev ? r[e] : r[e + 4]) + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        float4* pw = reinterpret_cast<float4*>(sm.part(a.group, cw, b - b0) + (lo ? 0 : D) +
                                               j * DL + (ev ? 0 : 4));
        const float4 old = *pw;
        *pw = make_float4(old.x + u[0], old.y + u[1], old.z + u[2], old.w + u[3]);
      }
      if (a.dpos != nullptr) {
        if (cur >= 0) store_dpos(a, cur, cw, g, col, dp, !first_pass);
        if (first_pass)
          for (int z = written; z < t1; ++z) store_dpos(a, z, cw, g, col, zero, false);
      }
      named_barrier(1, 32 * WARPS);
      if (ct == 0 && b0 + a.group >= a.batch) stamp(a, item, kStreamed);

      // ---- the chunk's dq of the pass's samples: the warps in warp order
      for (int i = ct; i < nb * 2 * D; i += 32 * WARPS) {
        const int bb = i / (2 * D), rd = i % (2 * D);
        float acc = 0.f;
#pragma unroll 4
        for (int w = 0; w < WARPS; ++w) acc += sm.part(a.group, w, bb)[rd];
        const int r = rd / D, d = rd % D;
        a.dq_part[(((size_t)c * a.batch + b0 + bb) * 2 + r) * hd_cols + h * D + d] =
            r == 0 ? scale * acc : acc;
      }
      __threadfence();
      named_barrier(1, 32 * WARPS);
    }

    // ---- the last block of the head adds the chunks in chunk order
    if (ct == 0) stamp(a, item, kMerged);
    if (ct == 0) *sm.flag() = atomicAdd(a.ticket + h, 1) == a.chunks - 1;
    named_barrier(1, 32 * WARPS);
    if (*sm.flag()) {
      // VALS values a thread, each summed over the chunks in order, their
      // loads issued together
      constexpr int VALS = 4;
      __threadfence();
      const size_t step = (size_t)a.batch * 2 * hd_cols;
      for (int i0 = ct; i0 < a.batch * 2 * D; i0 += VALS * 32 * WARPS) {
        size_t at[VALS];
        float acc[VALS];
#pragma unroll
        for (int u = 0; u < VALS; ++u) {
          const int i = min(i0 + u * 32 * WARPS, a.batch * 2 * D - 1);
          at[u] = ((size_t)(i / (2 * D)) * 2 + (i / D) % 2) * hd_cols + h * D + i % D;
          acc[u] = 0.f;
        }
#pragma unroll 4
        for (int c2 = 0; c2 < a.chunks; ++c2)
#pragma unroll
          for (int u = 0; u < VALS; ++u) acc[u] += __ldcg(a.dq_part + c2 * step + at[u]);
#pragma unroll
        for (int u = 0; u < VALS; ++u) {
          if (i0 + u * 32 * WARPS >= a.batch * 2 * D) break;
          if (a.dq_f32)
            static_cast<float*>(a.dq)[at[u]] = acc[u];
          else
            static_cast<bf16*>(a.dq)[at[u]] = __float2bfloat16(acc[u]);
        }
      }
      if (ct == 0) a.ticket[h] = 0;
    }
    named_barrier(1, 32 * WARPS);
    if (ct == 0) stamp(a, item, kDone);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_attention_bwd_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_pos, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (ALIGN - (raw & (ALIGN - 1))) & (ALIGN - 1);
  const Smem sm{smem_raw + pad, raw + pad};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), WARPS);
    }
    for (int p = 0; p < 2; ++p) {
      mbar_init(sm.pos_full(p), 1);
      mbar_init(sm.pos_empty(p), WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) stamp(a, blockIdx.x, kStart);
  if (warp == 0)
    produce(sm, a, &map_k, &map_v, &map_pos, lane);
  else
    consume(sm, a, warp - 1, lane);
}

}  // namespace

// dq [B, 2, H * 64] (rows dq_smax, dq_coda; f32 when dq_f32, else bf16),
// dpos [L, H, 64] f32 (or none when pos is null) and, when dk is not null,
// dK and dV [B, L, H, 64] bf16 in one launch, from
// queries qs / qc (row stride q_stride elements between samples, heads x 64
// contiguous, bf16), ct [B, H, 64] (f32 when ct_f32, else bf16), o_s [B, H,
// 64] f32, denom / mx [B, H] f32 rows stat_stride apart, K/V [B, L, H, 64]
// bf16 (already offset to the slot), mask [B, L] bytes and pos [L, H, 64]
// bf16 or null. dq_part is scratch of [chunks, B, 2, H * 64] f32, ticket
// [H] int32 zeroed (and left zeroed). The geometry (tiles, chunk_tiles,
// chunks, group, grid, smem) is ops/_cuda.py bwd_geometry's; the wrapper
// checks shapes and alignment. clock: null, or grid x CLOCKS int64 for the
// stage clock.
extern "C" int dfd_decoder_attention_bwd(const void* qs, const void* qc, long long q_stride,
                                         const void* ct, int ct_f32, const void* o_s,
                                         const void* denom, const void* mx,
                                         long long stat_stride, const void* k, const void* v,
                                         const void* mask, const void* pos, void* dq_part,
                                         void* dq, int dq_f32, void* dpos, void* dk, void* dv,
                                         void* ticket,
                                         int batch, int L, int heads, int tiles, int chunk_tiles,
                                         int chunks, int group, int grid, int smem, float scale,
                                         void* clock, void* stream) {
  if (batch < 1 || L < 1 || heads < 1 || group < 1 || group > batch || chunk_tiles < 1 ||
      tiles != (L + TILE - 1) / TILE || chunks != (tiles + chunk_tiles - 1) / chunk_tiles ||
      grid < 1 || smem < TABLE_OFF + ALIGN || (long long)batch * L > 0x7fffffffLL ||
      (dk == nullptr) != (dv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long width = (long long)heads * D;
  alignas(64) CUtensorMap mk, mv, mp;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)L, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)width * 2 * L};
  const cuuint32_t box[3] = {D, TILE, 1}, elem[3] = {1, 1, 1};
  CUtensorMap* maps[2] = {&mk, &mv};
  const void* bases[2] = {k, v};
  for (int i = 0; i < 2; ++i)
    if (fn(maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(bases[i]), dims,
           strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  mp = mk;   // unread without pos
  if (pos != nullptr && !encode_2d(&mp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, pos, width, L,
                                   width * 2, D, TILE, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qs = static_cast<const bf16*>(qs);
  a.qc = static_cast<const bf16*>(qc);
  a.q_stride = q_stride;
  a.ct = ct;
  a.o_s = static_cast<const float*>(o_s);
  a.denom = static_cast<const float*>(denom);
  a.mx = static_cast<const float*>(mx);
  a.stat_stride = stat_stride;
  a.mask = static_cast<const unsigned char*>(mask);
  a.dq_part = static_cast<float*>(dq_part);
  a.dq = dq;
  a.dpos = static_cast<float*>(dpos);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.ticket = static_cast<int*>(ticket);
  a.clock = static_cast<long long*>(clock);
  a.ct_f32 = ct_f32;
  a.dq_f32 = dq_f32;
  a.has_pos = pos != nullptr;
  a.batch = batch;
  a.L = L;
  a.heads = heads;
  a.tiles = tiles;
  a.chunk_tiles = chunk_tiles;
  a.chunks = chunks;
  a.group = group;
  a.scale = scale;
  cudaError_t err = cudaFuncSetAttribute(decoder_attention_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decoder_attention_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      mk, mv, mp, a);
  return static_cast<int>(cudaGetLastError());
}
