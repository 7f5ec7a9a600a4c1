// Single-query dual-activation (softmax + CoDA) decoder attention.
//
// Replaces: dfd_clip_tpu/ops/pallas_decoder_attention.py
// fused_decoder_attention (_kernel, forward, with and without `partials`; the
// normalised forward also on int8_rows K/V with per-row scales, the `deq`
// stage): one query per (sample, head) over L = frames x patches
// tokens of slot `layer` of the stacked encoder export, with the shared
// temporal positional embedding added to K and V, the token mask, an exact
// softmax, and CoDA's tanh(q_c . k) * 2 sigmoid(-|q_c - k|_1 * scale).
// The `partials` form (the training forward) writes the softmax state
// instead of the normalised output: the un-normalised numerator and the CoDA
// output (B, 2, H*D) f32, and the denominator and maximum (B, 2, H) f32,
// both relative to the merged maximum. With int8 K/V (kv_dtype "int8_rows")
// each token's K row is int8 * k_scale and its V row int8 * v_scale, in
// f32, before the embedding is added to both; the TPU kernel rounds the
// dequantised K and the scale to bf16 instead (ROADMAP queue 3).
//
// Bound on an H100: bytes. There are 2 query rows a head and ~0.2 GFLOP a
// call against ~197 MB of K/V at the flagship shape (16 samples, 12 heads,
// 4000 tokens, head_dim 64; half that with int8 K/V), so no tensor cores:
// the design is about bytes in flight and parallelism.
//
// Design: L is split into chunks of 64 tokens. A block takes one (head,
// chunk), heads fastest in the grid (the blocks resident together read
// whole token rows), and walks the B samples, so the chunk's pos tile is
// loaded once into shared memory and serves every sample (pos is read once
// a call). One producer lane moves each sample's K and V tiles (64 tokens x
// 64 dims of one head) with TMA, through 2-D tensor maps over (B*L, H*64),
// into a 48 KB ring on mbarriers (3 bf16 stages, 6 int8); rows past the end
// read 0, and a sample with no valid token in the chunk (a padded batch
// row) moves no bytes. Four consumer warps take 16 rows of each tile each, copy them to
// registers and hand the stage back before any arithmetic. A token's 64
// dims lie on 8 lanes (csrc/decoder_logits.cuh, shared with the backward),
// so a warp works on 4 tokens at once and a token's three reductions take 3
// shuffles each; lane j of a group takes the exponentials of the group's
// token j % 4 and the group shares them. A warp keeps one softmax state of
// its 16 tokens of the sample (maximum over the warp, denominator,
// numerator, CoDA sum) in f32, its 4 groups added by shuffles, and the 4
// warps merge through shared memory into the chunk's state: numerator (64),
// CoDA sum (64), denominator, maximum, in a (B, H, chunks, 132) f32
// workspace. A second launch merges the chunks of each (sample, head) in a
// fixed order with JAX's combine (dfd_clip_tpu/ops/spmd.py): no atomics, so
// results do not vary from run to run. The mask, the int8 scales and the
// next sample's queries are read by the consumers one sample ahead. Masked
// and out-of-range tokens contribute exactly 0 (their values are never
// accumulated); the maximum starts at the finite -1e30 and the denominator
// is floored at 1e-30, so a fully masked sample returns 0, not NaN
// (partials: numerator 0, denominator 0, maximum -1e30). The softmax and
// CoDA weights use the fast exponential and division (__expf, __fdividef):
// the output holds within the decoder's 1e-2 of the plain version, and the
// backward needs only the logits, which are exact.
#include <type_traits>

#include "decoder_logits.cuh"
#include "hopper.cuh"

namespace {

using namespace dec;
using namespace hopper;

constexpr int CHUNK = 64;                        // tokens a chunk (ops/_cuda.py DECODER_CHUNK)
constexpr int CONSUMERS = 4;                     // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);    // and the producer warp
constexpr int ROWS = CHUNK / CONSUMERS;          // tile rows a consumer warp
constexpr int STEPS = ROWS / TOKENS;             // its steps of 4 tokens
constexpr int RING_BYTES = 48 * 1024;            // a block's ring: 3 bf16 stages, 6 int8
constexpr int MIN_BLOCKS = 3;                    // resident blocks an SM (shared memory's)
constexpr int WS = 132;   // workspace floats a chunk: numerator, CoDA, denominator, maximum, pad
constexpr int POS_BYTES = CHUNK * D * 2;
// the merge buffer, two of them (by sample parity): maximum and denominator
// of each consumer warp, then its numerator and CoDA sum
constexpr int MERGE_FLOATS = 2 * CONSUMERS + 2 * CONSUMERS * D;
static_assert(ROWS % TOKENS == 0 && WS >= 2 * D + 2 && CONSUMERS * 32 >= 2 * D, "chunk layout");

template <typename KV>
struct Tile {
  // a lane's 8 values of a row: 16 bytes of bf16, 8 of int8
  using Raw = typename std::conditional<sizeof(KV) == 2, uint4, uint2>::type;
  static constexpr int ROW = D * (int)sizeof(KV);   // bytes a token row
  static constexpr int BYTES = CHUNK * ROW;         // one K or V tile
  static constexpr int STAGE = 2 * BYTES;           // K then V
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int BAR_OFF = POS_BYTES + STAGES * STAGE + 2 * MERGE_FLOATS * 4;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8 + 128;   // + alignment slack
};

// A lane's 8 values of a K or V row, as f32 (int8: times the token's scale).
__device__ __forceinline__ void widen(const uint4& raw, float, float (&f)[DL]) { unpack8(raw, f); }
__device__ __forceinline__ void widen(const uint2& raw, float scale, float (&f)[DL]) {
  unpack8(raw, scale, f);
}

// What the consumers read ahead for one sample: this lane's 8 dims of both
// queries, the warp's 16 tokens' mask bits (ballot), and (int8) the scale
// of token `lane` of the warp's 16 on lanes 0-15.
struct Ahead {
  uint4 qs, qc;
  unsigned valid;
  float ks, vs;
};

template <typename KV>
__device__ __forceinline__ Ahead read_ahead(const bf16* qs, const bf16* qc, long long q_stride,
                                            const float* k_scale, const float* v_scale,
                                            const unsigned char* mask, int b, int h, int j,
                                            int lane, long long tok, int L) {
  Ahead a;
  const size_t q = (size_t)b * q_stride + (size_t)h * D + j * DL;
  a.qs = *reinterpret_cast<const uint4*>(qs + q);
  a.qc = *reinterpret_cast<const uint4*>(qc + q);
  const bool in = lane < ROWS && tok < L;
  const size_t at = (size_t)b * L + (size_t)(in ? tok : 0);
  a.valid = __ballot_sync(0xffffffffu, in && mask[at] != 0);
  a.ks = a.vs = 0.f;
  if (sizeof(KV) == 1 && in) {
    a.ks = k_scale[at];
    a.vs = v_scale[at];
  }
  return a;
}

// Whether sample b has a valid token among the chunk's 64 from `tok` on
// (lane l asks for tokens tok + 0, 1 with tok = first + 2 l; warp-wide).
__device__ __forceinline__ bool chunk_live(const unsigned char* mask, int b, int tok, int L) {
  const unsigned char* mb = mask + (size_t)b * L;
  const bool any = (tok < L && mb[tok] != 0) || (tok + 1 < L && mb[tok + 1] != 0);
  return __any_sync(0xffffffffu, any);
}

template <typename KV>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decoder_attention_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_pos, int has_pos,
                         const bf16* __restrict__ qs, const bf16* __restrict__ qc,
                         long long q_stride, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const unsigned char* __restrict__ mask, float* __restrict__ ws,
                         int batch, int L, int heads, float scale) {
  using T = Tile<KV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((128u - (raw & 127u)) & 127u);   // 128-byte aligned
  unsigned char* pos_s = base;
  unsigned char* ring = base + POS_BYTES;
  float* merge = reinterpret_cast<float*>(ring + T::STAGES * T::STAGE);
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(base + T::BAR_OFF));
  const auto full = [&](int s) { return bars + 8u * s; };
  const auto empty = [&](int s) { return bars + 8u * (T::STAGES + s); };
  const uint32_t pos_bar = bars + 8u * 2 * T::STAGES;

  const int h = blockIdx.x, c = blockIdx.y, chunks = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(pos_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 0) {
    // ---- the producer warp: the pos tile once, then each sample's K and V
    // tiles; a sample with no valid token in the chunk moves no bytes (its
    // stage is handed over unfilled, and the consumers accumulate nothing)
    if (lane == 0 && has_pos) {
      mbar_expect_tx(pos_bar, POS_BYTES);
      tma_load(static_cast<uint32_t>(__cvta_generic_to_shared(pos_s)), &map_pos, pos_bar, h * D,
               c * CHUNK);
    }
    bool live_next = chunk_live(mask, 0, c * CHUNK + 2 * lane, L);
    for (int b = 0; b < batch; ++b) {
      const bool live = live_next;
      if (b + 1 < batch) live_next = chunk_live(mask, b + 1, c * CHUNK + 2 * lane, L);
      if (lane == 0) {
        const int s = b % T::STAGES;
        if (b >= T::STAGES) mbar_wait(empty(s), (b / T::STAGES - 1) & 1);
        if (live) {
          const uint32_t dst =
              static_cast<uint32_t>(__cvta_generic_to_shared(ring + s * T::STAGE));
          mbar_expect_tx(full(s), T::STAGE);
          tma_load(dst, &map_k, full(s), h * D, b * L + c * CHUNK);
          tma_load(dst + T::BYTES, &map_v, full(s), h * D, b * L + c * CHUNK);
        } else {
          mbar_arrive(full(s));
        }
      }
      __syncwarp();
    }
    return;
  }

  // ---- the consumers ------------------------------------------------------------------
  const int cw = warp - 1, ct = threadIdx.x - 32;
  const int g = lane / GROUP, j = lane % GROUP;
  const int row0 = cw * ROWS;   // the warp's first tile row
  const long long tok = (long long)c * CHUNK + row0 + lane;   // lane's token for read_ahead
  if (has_pos) {
    mbar_wait(pos_bar, 0);
  } else {
    for (int i = ct; i < POS_BYTES / 16; i += 32 * CONSUMERS)
      reinterpret_cast<uint4*>(pos_s)[i] = make_uint4(0, 0, 0, 0);
    named_barrier(1, 32 * CONSUMERS);
  }

  Ahead next = read_ahead<KV>(qs, qc, q_stride, k_scale, v_scale, mask, 0, h, j, lane, tok, L);
  for (int b = 0; b < batch; ++b) {
    const Ahead cur = next;
    if (b + 1 < batch)
      next = read_ahead<KV>(qs, qc, q_stride, k_scale, v_scale, mask, b + 1, h, j, lane, tok, L);
    float q_s[DL], q_c[DL];
    unpack8(cur.qs, q_s);
    unpack8(cur.qc, q_c);

    const int s = b % T::STAGES;
    mbar_wait(full(s), (b / T::STAGES) & 1);
    const unsigned char* kt = ring + s * T::STAGE;
    const unsigned char* vt = kt + T::BYTES;

    // the warp's rows of the tile into registers, and the stage back to the producer
    typename T::Raw kr[STEPS], vr[STEPS];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int off = (row0 + st * TOKENS + g) * T::ROW + j * (int)sizeof(typename T::Raw);
      kr[st] = *reinterpret_cast<const typename T::Raw*>(kt + off);
      vr[st] = *reinterpret_cast<const typename T::Raw*>(vt + off);
    }
    warp_arrive(empty(s));

    float ls[STEPS], lc[STEPS], l1[STEPS], vp[STEPS][DL];
    bool ok[STEPS];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int t = st * TOKENS + g;   // the token among the warp's 16
      float ksc = 0.f, vsc = 0.f;
      if (sizeof(KV) == 1) {
        ksc = __shfl_sync(0xffffffffu, cur.ks, t);
        vsc = __shfl_sync(0xffffffffu, cur.vs, t);
      }
      float k[DL], p[DL];
      widen(kr[st], ksc, k);
      widen(vr[st], vsc, vp[st]);
      unpack8(*reinterpret_cast<const uint4*>(pos_s + (row0 + t) * (D * 2) + j * 16), p);
      const Logits lg = token_logits(q_s, q_c, k, p, scale);
#pragma unroll
      for (int e = 0; e < DL; ++e) vp[st][e] = __fadd_rn(vp[st][e], p[e]);
      ok[st] = (cur.valid >> t) & 1u;
      ls[st] = lg.ls;
      lc[st] = lg.lc;
      l1[st] = lg.l1;
    }

    // The warp's maximum over its valid tokens; the group's 8 lanes hold the
    // same logits of its STEPS tokens, so lane j takes the exponentials of
    // token j % STEPS and the group shares them.
    float m = NEG_BIG;
#pragma unroll
    for (int st = 0; st < STEPS; ++st)
      if (ok[st]) m = fmaxf(m, ls[st]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
    const int mine = j % STEPS;
    float my_ls = ls[0], my_lc = lc[0], my_l1 = l1[0];
#pragma unroll
    for (int st = 1; st < STEPS; ++st) {
      my_ls = mine == st ? ls[st] : my_ls;
      my_lc = mine == st ? lc[st] : my_lc;
      my_l1 = mine == st ? l1[st] : my_l1;
    }
    const float my_p = __expf(my_ls - m);
    const float my_wc = (1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * my_lc))) *   // tanh
                        __fdividef(2.0f, 1.0f + __expf(my_l1 * scale));            // gate
    float den = 0.f, num[DL], cod[DL];
#pragma unroll
    for (int e = 0; e < DL; ++e) num[e] = cod[e] = 0.f;
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const float p = __shfl_sync(0xffffffffu, my_p, g * GROUP + st);
      const float wc = __shfl_sync(0xffffffffu, my_wc, g * GROUP + st);
      if (ok[st]) {
        den += p;
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          num[e] += p * vp[st][e];
          cod[e] += wc * vp[st][e];
        }
      }
    }
    // the 4 groups' sums (one maximum): lanes 0-7 hold the warp's
#pragma unroll
    for (int o = 8; o < 32; o *= 2) {
      den += __shfl_xor_sync(0xffffffffu, den, o);
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        num[e] += __shfl_xor_sync(0xffffffffu, num[e], o);
        cod[e] += __shfl_xor_sync(0xffffffffu, cod[e], o);
      }
    }

    // ---- the warps' states -> the chunk's, through shared memory -----------------------
    float* mb = merge + (b & 1) * MERGE_FLOATS;
    if (lane < GROUP) {
      if (lane == 0) {
        mb[cw] = m;
        mb[CONSUMERS + cw] = den;
      }
      float4* nd = reinterpret_cast<float4*>(mb + 2 * CONSUMERS + cw * D + j * DL);
      float4* cd = reinterpret_cast<float4*>(mb + 2 * CONSUMERS + (CONSUMERS + cw) * D + j * DL);
      nd[0] = make_float4(num[0], num[1], num[2], num[3]);
      nd[1] = make_float4(num[4], num[5], num[6], num[7]);
      cd[0] = make_float4(cod[0], cod[1], cod[2], cod[3]);
      cd[1] = make_float4(cod[4], cod[5], cod[6], cod[7]);
    }
    named_barrier(1, 32 * CONSUMERS);

    // thread ct < 64: numerator dim ct (and the denominator); 64 <= ct < 128: CoDA dim ct - 64
    float mm = NEG_BIG;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) mm = fmaxf(mm, mb[w]);
    const int d = ct % D;
    float* out = ws + (((size_t)b * heads + h) * chunks + c) * WS;
    if (ct < D) {
      float acc = 0.f, dd = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
        const float f = __expf(mb[w] - mm);
        acc += mb[2 * CONSUMERS + w * D + d] * f;
        dd += mb[CONSUMERS + w] * f;
      }
      out[d] = acc;
      if (d == 0) {
        out[2 * D] = dd;
        out[2 * D + 1] = mm;
      }
    } else if (ct < 2 * D) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) acc += mb[2 * CONSUMERS + (CONSUMERS + w) * D + d];
      out[D + d] = acc;
    }
  }
}

// The chunks of one (sample, head) in a fixed order, with JAX's combine:
// r_c = exp(max_c - max), numerator and denominator sum_c x_c r_c, CoDA
// sum_c x_c. MERGE_SLICES x 64 threads: the chunks' maxima and scale factors
// go through shared memory, slice k sums chunks k, k + MERGE_SLICES, ... in
// order (independent loads, a dim a thread), and the slices add up in order.
constexpr int MERGE_SLICES = 4;
constexpr int MERGE_CHUNKS = 512;   // chunks a pass

template <bool PARTIALS>
__global__ void __launch_bounds__(MERGE_SLICES * D)
decoder_merge_kernel(const float* __restrict__ ws, int chunks, int heads, bf16* __restrict__ out,
                     float* __restrict__ o_sc, float* __restrict__ st) {
  constexpr int WARPS = MERGE_SLICES * D / 32;
  __shared__ float sm_r[MERGE_CHUNKS], sm_part[MERGE_SLICES][3][D], sm_max[WARPS];
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int t = threadIdx.x, k = t / D, d = t % D;
  const float* w = ws + (size_t)blockIdx.x * chunks * WS;
  float mm = NEG_BIG;
  for (int c = t; c < chunks; c += MERGE_SLICES * D) mm = fmaxf(mm, w[(size_t)c * WS + 2 * D + 1]);
  mm = warp_max(mm);
  if (t % 32 == 0) sm_max[t / 32] = mm;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < WARPS; ++i) mm = fmaxf(mm, sm_max[i]);
  float num = 0.f, cod = 0.f, den = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += MERGE_CHUNKS) {
    const int n = min(MERGE_CHUNKS, chunks - c0);
    __syncthreads();
    for (int c = t; c < n; c += MERGE_SLICES * D)
      sm_r[c] = expf(w[(size_t)(c0 + c) * WS + 2 * D + 1] - mm);
    __syncthreads();
#pragma unroll 4
    for (int c = k; c < n; c += MERGE_SLICES) {
      const float* x = w + (size_t)(c0 + c) * WS;
      const float r = sm_r[c];
      num += x[d] * r;
      cod += x[D + d];
      den += x[2 * D] * r;
    }
  }
  sm_part[k][0][d] = num;
  sm_part[k][1][d] = cod;
  sm_part[k][2][d] = den;
  __syncthreads();
  if (k != 0) return;
  for (int i = 1; i < MERGE_SLICES; ++i) {
    num += sm_part[i][0][d];
    cod += sm_part[i][1][d];
    den += sm_part[i][2][d];
  }
  const size_t hd = (size_t)heads * D;
  if (PARTIALS) {
    o_sc[(size_t)b * 2 * hd + h * D + d] = num;
    o_sc[(size_t)b * 2 * hd + hd + h * D + d] = cod;
    if (d == 0) {
      st[(size_t)b * 2 * heads + h] = den;
      st[(size_t)b * 2 * heads + heads + h] = mm;
    }
  } else {
    out[(size_t)b * hd + h * D + d] = __float2bfloat16(0.5f * (num / fmaxf(den, 1e-30f) + cod));
  }
}

template <typename KV>
int launch(const CUtensorMap& mk, const CUtensorMap& mv, const CUtensorMap& mp, int has_pos,
           const bf16* qs, const bf16* qc, long long q_stride, const float* k_scale,
           const float* v_scale, const unsigned char* mask, float* ws, int chunks, int batch,
           int L, int heads, float scale, cudaStream_t st) {
  auto kernel = decoder_attention_kernel<KV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<KV>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, chunks), THREADS, Tile<KV>::SMEM, st>>>(
      mk, mv, mp, has_pos, qs, qc, q_stride, k_scale, v_scale, mask, ws, batch, L, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The attention over queries qs / qc (row stride q_stride elements between
// samples, heads x 64 contiguous, 16-byte aligned), K/V [B, L, H, 64]
// (already offset to the slot; int8 when k_scale is not null, with k_scale /
// v_scale [B, L] f32 offset to the same slot, else bf16), mask [B, L]
// bytes and pos [L, H, 64] bf16 or null. ws is scratch of [B, H, chunks,
// 132] f32, chunks = ceil(L / 64). With out (bf16 [B, H * 64]) the
// normalised output; with out null the partials form into o_sc [B, 2, H *
// 64] and st [B, 2, H] (f32). Two launches: the chunks, then their merge.
// The wrapper checks shapes and alignment.
extern "C" int dfd_decoder_attention(const void* qs, const void* qc, long long q_stride,
                                     const void* k, const void* v, const float* k_scale,
                                     const float* v_scale, const void* mask, const void* pos,
                                     void* ws, int chunks, void* out, void* o_sc, void* st,
                                     int batch, int L, int heads, float scale, void* stream) {
  if (batch < 1 || L < 1 || heads < 1 || chunks > 65535 || chunks != (L + CHUNK - 1) / CHUNK ||
      (long long)batch * L > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = k_scale != nullptr;
  const CUtensorMapDataType type =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long width = (long long)heads * D, pitch = width * (int8 ? 1 : 2);
  alignas(64) CUtensorMap mk, mv, mp;
  if (!encode_2d(&mk, type, k, width, (long long)batch * L, pitch, D, CHUNK,
                 CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_2d(&mv, type, v, width, (long long)batch * L, pitch, D, CHUNK,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  mp = mk;   // unread without pos
  if (pos != nullptr &&
      !encode_2d(&mp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, pos, width, L, width * 2, D, CHUNK,
                 CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const bf16* q_s = static_cast<const bf16*>(qs);
  const bf16* q_c = static_cast<const bf16*>(qc);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* w = static_cast<float*>(ws);
  const int err =
      int8 ? launch<int8_t>(mk, mv, mp, pos != nullptr, q_s, q_c, q_stride, k_scale, v_scale, m,
                            w, chunks, batch, L, heads, scale, cs)
           : launch<bf16>(mk, mv, mp, pos != nullptr, q_s, q_c, q_stride, nullptr, nullptr, m, w,
                          chunks, batch, L, heads, scale, cs);
  if (err != 0) return err;
  if (out != nullptr)
    decoder_merge_kernel<false><<<batch * heads, MERGE_SLICES * D, 0, cs>>>(w, chunks, heads,
                                                             static_cast<bf16*>(out), nullptr,
                                                             nullptr);
  else
    decoder_merge_kernel<true><<<batch * heads, MERGE_SLICES * D, 0, cs>>>(
        w, chunks, heads, nullptr, static_cast<float*>(o_sc), static_cast<float*>(st));
  return static_cast<int>(cudaGetLastError());
}
