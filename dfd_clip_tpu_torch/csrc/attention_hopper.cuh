// The bf16 encoder attention's body: the K/V and Q producers and the wgmma
// consumers of csrc/encoder_attention.cu, whose header describes the design,
// as device functions over NCONS consumer warpgroups, and the attention
// study's consumer (consume_rows, its P rounding point a template
// parameter: csrc/study_attention.cu). The per-layer kernel
// (encoder_attention.cu) runs them once with three consumers; the
// whole-encoder tower (csrc/encoder_tower.cu) runs them once an attention
// stage with two, its GEMM stages' block shape. A query tile's keys are
// walked in the same blocks of 64 whatever NCONS, so its output does not
// depend on it. The ring and Q-buffer counters (Counts) carry from one call
// to the next, so the mbarriers keep their phases across the tower's stages.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace hattn {

using namespace hopper;

constexpr int D = 64;
constexpr int BM = 64;                  // query rows of a consumer's tile
constexpr int BK = 64;                  // keys of a ring stage
constexpr int STAGES = 10;              // ring stages: an item of <= 640 tokens stays resident
constexpr int TILE_BYTES = BK * D * 2;  // 8 KB: one 64 x 64 bf16 box
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int Q_OFF = STAGES * STAGE_BYTES;
constexpr float LOG2E = 1.4426950408889634f;

template <int NCONS>
struct Layout {
  // the K/V ring, two Q buffers a consumer
  static constexpr int DATA_BYTES = Q_OFF + 2 * NCONS * TILE_BYTES;
  // kv_full, kv_empty (STAGES each), q_full, q_empty (NCONS consumers x 2 buffers)
  static constexpr int BAR_BYTES = (2 * STAGES + 4 * NCONS) * 8;
};

__device__ __forceinline__ void fence_regs(uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}
using hopper::fence_regs;

#define DFD_ACC32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define DFD_D32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32) (+)= A (64 x 16, K-major in shared memory) x B (16 x 64,
// K-major: 64 rows of 16 K values); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DFD_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DFD_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same for B of 16 rows (N = 16): d[0 .. 7] only.
__device__ __forceinline__ void wgmma_ss16(float (&d)[8], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, the m16n8k16 A fragment
// of each warp's 16 rows) x B (16 x 64, MN-major in shared memory: 16 rows
// of 64 N values, transposed by the instruction).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DFD_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DFD_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef DFD_ACC32
#undef DFD_D32

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the schedule ------------------------------------------------------------------
struct Geometry {
  int tokens, heads, items;
  int nkb;        // key blocks of an item (= its query tiles)
  int slots;      // query slots of an item: its tiles, or NCONS a group
  int resident;   // the item's K/V stays in the ring while all its tiles walk it
  int per_item;   // K/V block loads an item takes
};

template <int NCONS>
__host__ __device__ inline Geometry geometry(int frames, int tokens, int heads) {
  Geometry g;
  g.tokens = tokens;
  g.heads = heads;
  g.items = frames * heads;
  g.nkb = (tokens + BK - 1) / BK;
  const int groups = (g.nkb + NCONS - 1) / NCONS;   // of NCONS query tiles
  g.resident = g.nkb <= STAGES;
  g.per_item = g.resident ? g.nkb : groups * g.nkb;
  g.slots = g.resident ? g.nkb : groups * NCONS;
  return g;
}

// Two key blocks or more, the last of <= 16 real keys: its N = 16 products
// (the NARROW form).
__host__ __device__ inline bool narrow(int tokens) {
  const int nkb = (tokens + BK - 1) / BK;
  return nkb >= 2 && tokens - (nkb - 1) * BK <= 16;
}

// The query slots of a block, in one order for every role: slot f is tile
// f % slots of the block's item f / slots, and consumer f % NCONS takes it.
// With the K/V resident the slots are the item's tiles, so a consumer may
// pass on to the next item while the others finish this one (no consumer
// idles at the end of an item); above the ring's 640 tokens they are groups
// of NCONS tiles that walk the refilled ring together, the last group's
// tiles past the frame's end idle.
struct Slot {
  int item;    // the block's item index (its work item is blockIdx.x + item x gridDim.x)
  int tile;    // query tile, 64 rows
  int first;   // K/V load index of key block 0, within the call
};

template <int NCONS>
__device__ __forceinline__ Slot slot_of(const Geometry& g, int f) {
  const int item = f / g.slots, tile = f % g.slots;
  return {item, tile, item * g.per_item + (g.resident ? 0 : tile / NCONS * g.nkb)};
}

__device__ __forceinline__ int items_of_block(const Geometry& g) {
  return (g.items - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
         static_cast<int>(gridDim.x);
}

// K/V loads and each consumer's Q slots before this call: every thread of
// the block keeps a copy and advances it after each call.
template <int NCONS>
struct Counts {
  int kv = 0;
  int q[NCONS] = {};
  __device__ void advance(const Geometry& g) {
    const int items = items_of_block(g), total = items * g.slots;
    kv += items * g.per_item;
#pragma unroll
    for (int c = 0; c < NCONS; ++c) q[c] += total > c ? (total - c + NCONS - 1) / NCONS : 0;
  }
};

// Shared-memory addresses: the K/V ring, the Q buffers and the barriers.
template <int NCONS>
struct Smem {
  uint32_t base;   // the data, 1024-byte aligned
  uint32_t bars;   // Layout<NCONS>::BAR_BYTES of barriers
  __device__ uint32_t kv_tile(int s, int which) const {
    return base + s * STAGE_BYTES + which * TILE_BYTES;
  }
  __device__ uint32_t q_tile(int c, int b) const { return base + Q_OFF + (2 * c + b) * TILE_BYTES; }
  __device__ uint32_t kv_full(int s) const { return bars + 8u * s; }
  __device__ uint32_t kv_empty(int s) const { return bars + 8u * (STAGES + s); }
  __device__ uint32_t q_full(int c, int b) const { return bars + 8u * (2 * STAGES + 2 * c + b); }
  __device__ uint32_t q_empty(int c, int b) const {
    return bars + 8u * (2 * STAGES + 2 * NCONS + 2 * c + b);
  }
  // One thread, once a launch (a geometry of the launch's token count),
  // then a block-wide sync before any role runs.
  __device__ void init(const Geometry& g) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kv_full(s), 1);
      // the 4 warps of each slot that reads the block: all the item's tiles
      // when resident, else the group's NCONS
      mbar_init(kv_empty(s), 4 * (g.resident ? g.nkb : NCONS));
    }
    for (int c = 0; c < NCONS; ++c)
      for (int b = 0; b < 2; ++b) {
        mbar_init(q_full(c, b), 1);
        mbar_init(q_empty(c, b), 4);
      }
    mbar_fence_init();
  }
};

// The online softmax of one key block's S in base 2, in place: x = s
// d^-1/2 log2(e), keys past the frame's end (`last` block only) at -inf;
// key 64 j is real, so every row maximum is finite. m: running maxima of
// x, l: running sums of the f32 exps, alpha = 2^(m_old - m_new). The
// exps stay in s (N = 32: a block of 64 keys; 8: the N = 16 tail).
template <int N>
__device__ __forceinline__ void softmax(float (&s)[N], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], bool last, int key0, int tokens,
                                        float coef) {
  if (last) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      s[i] = key0 + (i / 4) * 8 + (i & 1) < tokens ? s[i] : -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mnew = fmaxf(m[r], quad_max(mx[r]) * coef);
    alpha[r] = ex2(m[r] - mnew);   // 0 on the first block
    m[r] = mnew;
    mc[r] = -mnew;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = ex2(fmaf(s[i], coef, mc[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// ---- the roles ---------------------------------------------------------------------
// The K/V ring (one thread): every key block of the block's items, through
// the 3-D tensor maps of K and V (kernel parameters).
template <int NCONS>
__device__ __forceinline__ void produce_kv(const Smem<NCONS>& sm, const Geometry& g,
                                           const CUtensorMap* map_k, const CUtensorMap* map_v,
                                           const Counts<NCONS>& cnt) {
  int n = cnt.kv;   // K/V block loads so far
  for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
    const int frame = it / g.heads, col = (it % g.heads) * D;
    for (int i = 0; i < g.per_item; ++i, ++n) {
      const int s = n % STAGES, j = i % g.nkb;
      mbar_wait(sm.kv_empty(s), ((n / STAGES) & 1) ^ 1);
      mbar_expect_tx(sm.kv_full(s), STAGE_BYTES);
      tma_load(sm.kv_tile(s, 0), map_k, sm.kv_full(s), col, j * BK, frame);
      tma_load(sm.kv_tile(s, 1), map_v, sm.kv_full(s), col, j * BK, frame);
    }
  }
}

// The consumers' Q tiles (one thread), slot by slot, two buffers a consumer.
template <int NCONS>
__device__ __forceinline__ void produce_q(const Smem<NCONS>& sm, const Geometry& g,
                                          const CUtensorMap* map_q, const Counts<NCONS>& cnt) {
  const int total = items_of_block(g) * g.slots;
  for (int f = 0; f < total; ++f) {
    const Slot sl = slot_of<NCONS>(g, f);
    const int it = blockIdx.x + sl.item * gridDim.x;
    const int c = f % NCONS, n = cnt.q[c] + f / NCONS;   // the consumer and its slots so far
    const int b = n & 1;
    mbar_wait(sm.q_empty(c, b), ((n >> 1) & 1) ^ 1);
    mbar_expect_tx(sm.q_full(c, b), TILE_BYTES);
    tma_load(sm.q_tile(c, b), map_q, sm.q_full(c, b), (it % g.heads) * D, sl.tile * BM,
             it / g.heads);
  }
}

// Consumer C (0 to NCONS - 1) of the block: slots C, C + NCONS, ... A
// template on C, so that every branch around its products
// depends on the geometry and loop counters alone (uniform over the
// warpgroup: the compiler keeps the products asynchronous). out: (frames x
// tokens, heads x 64), f32 when OUT_F32, else bf16.
template <int NCONS, int C, bool OUT_F32, bool NARROW>
__device__ __forceinline__ void consume(const Smem<NCONS>& sm, const Geometry& g, float coef,
                                        void* __restrict__ out, const Counts<NCONS>& cnt) {
  const int wq = (threadIdx.x / 32) % 4;       // this warp's 16 rows of the tile
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;       // fragment row group and column pair
  const int total = items_of_block(g) * g.slots;
  for (int f = C, n = cnt.q[C]; f < total; f += NCONS, ++n) {   // n: this consumer's slots
    const Slot sl = slot_of<NCONS>(g, f);
    const int it = blockIdx.x + sl.item * gridDim.x;
    const int frame = it / g.heads, head = it % g.heads;
    const int b = n & 1, q0 = sl.tile * BM, first = cnt.kv + sl.first;
    mbar_wait(sm.q_full(C, b), (n >> 1) & 1);
    if (q0 >= g.tokens) {
      // a tile past the frame's end (the last group above 640 tokens):
      // keep the protocol only
      warp_arrive(sm.q_empty(C, b));
      for (int j = 0; j < g.nkb; ++j) {
        mbar_wait(sm.kv_full((first + j) % STAGES), ((first + j) / STAGES) & 1);
        warp_arrive(sm.kv_empty((first + j) % STAGES));
      }
      continue;
    }
    const uint64_t dq = sw128_desc(sm.q_tile(C, b));
    float o[32], s[32], st[8], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pc[BK / 16][4];   // P of the key block on the tensor cores
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = 0.f;

    // The steps of a key block, with the N = 16 form (TAIL) a compile-time
    // choice: the compiler keeps products asynchronous only where no
    // branch chooses between two products that write the same registers.
    // S = Q K_j^T, four k16 steps 32 bytes apart within the swizzled rows
    auto qk = [&](int j, auto tail) {
      const int ld = first + j;
      mbar_wait(sm.kv_full(ld % STAGES), (ld / STAGES) & 1);
      const uint64_t dk = sw128_desc(sm.kv_tile(ld % STAGES, 0));
      if constexpr (decltype(tail)::value) {
        fence_regs(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss16(st, dq + 2 * kk, dk + 2 * kk, kk);
        wgmma_commit();
        fence_regs(st);
      } else {
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
        wgmma_commit();
        fence_regs(s);
      }
    };
    // O += bf16(P_j) V_j, 16 keys a step (V's rows 2048 bytes apart)
    auto pv = [&](int j, auto tail) {
      const uint64_t dv = sw128_desc(sm.kv_tile((first + j) % STAGES, 1));
      fence_regs(o);
      fence_regs(pc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < (decltype(tail)::value ? 1 : BK / 16); ++kc)
        wgmma_rs(o, pc[kc], dv + kc * ((16 * 128) >> 4));
      wgmma_commit();
      fence_regs(o);
      fence_regs(pc);
    };
    // Block j: P_j V_j on the tensor cores, with S_{j+1} before it (MORE)
    // and the softmax of S_{j+1} beside it.
    auto step = [&](int j, auto qk_tail, auto pv_tail, auto more) {
      constexpr bool MORE = decltype(more)::value;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (decltype(pv_tail)::value)
            pc[kc][e] = kc ? 0u : pack_bf16(st[2 * e], st[2 * e + 1]);
          else
            pc[kc][e] = pack_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
        }
      if constexpr (MORE) qk(j + 1, qk_tail);
      pv(j, pv_tail);
      if constexpr (MORE) {
        wgmma_wait<1>();
        const bool last = j + 2 == g.nkb;
        if (last) warp_arrive(sm.q_empty(C, b));   // Q is no longer read
        if constexpr (decltype(qk_tail)::value) {
          fence_regs(st);
          softmax(st, m, l, alpha, last, (j + 1) * BK + 2 * t, g.tokens, coef);
        } else {
          fence_regs(s);
          softmax(s, m, l, alpha, last, (j + 1) * BK + 2 * t, g.tokens, coef);
        }
      }
      wgmma_wait<0>();
      fence_regs(o);
      warp_arrive(sm.kv_empty((first + j) % STAGES));
      if constexpr (MORE) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    };
    using Yes = std::true_type;
    using No = std::false_type;

    qk(0, No{});
    wgmma_wait<0>();
    fence_regs(s);
    if (g.nkb == 1) warp_arrive(sm.q_empty(C, b));
    softmax(s, m, l, alpha, g.nkb == 1, 2 * t, g.tokens, coef);
    for (int j = 0; j + 2 < g.nkb; ++j) step(j, No{}, No{}, Yes{});
    if (g.nkb >= 2) step(g.nkb - 2, std::bool_constant<NARROW>{}, No{}, Yes{});
    step(g.nkb - 1, No{}, std::bool_constant<NARROW>{}, No{});

    // O x (1 / sum), rows gr and gr + 8 of this warp's 16
    const int width = g.heads * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.0f / quad_sum(l[r]);
      const int row = q0 + wq * 16 + gr + 8 * r;
      if (row >= g.tokens) continue;
      const size_t at = ((size_t)frame * g.tokens + row) * width + head * D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const float a = o[4 * jj + 2 * r] * inv, bb = o[4 * jj + 2 * r + 1] * inv;
        if (OUT_F32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at + jj * 8) =
              make_float2(a, bb);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + at + jj * 8) =
              __floats2bfloat162_rn(a, bb);
      }
    }
  }
}

// Consumer c of the block (its warpgroup's index less one), as the
// compile-time consumer C that consume() takes.
template <int NCONS, bool OUT_F32, bool NARROW, int C = 0>
__device__ __forceinline__ void consume_as(int c, const Smem<NCONS>& sm, const Geometry& g,
                                           float coef, void* __restrict__ out,
                                           const Counts<NCONS>& cnt) {
  if constexpr (C < NCONS) {
    if (c == C)
      consume<NCONS, C, OUT_F32, NARROW>(sm, g, coef, out, cnt);
    else
      consume_as<NCONS, OUT_F32, NARROW, C + 1>(c, sm, g, coef, out, cnt);
  }
}

// ---- the attention study's consumer -----------------------------------------------
// Where a consumer rounds P to bf16 before P V. kOnline is consume()'s (the
// encoder attention's): exp(s - the running maximum) unnormalised, the
// output rescaled as the maximum moves and multiplied by 1 / sum after PV.
// The attention study's modes (csrc/study_attention.cu) round at points
// that need the whole row's maximum (and sum) first, which consume_rows()
// takes as its ROUND: kNormP ("bf16"): exp(s - max) / sum rounded, the
// output not divided; kDiet: exp(s - max) rounded, the output divided by the
// f32 sum of the unrounded exps; kDietNoMax: exp(s) rounded, divided
// likewise.
enum Round : int { kOnline = 0, kNormP = 1, kDiet = 2, kDietNoMax = 3 };

// The study's consumer C, for items of NKB <= 4 key blocks (at most 256
// tokens: resident in the ring). A query tile's S for every key block is
// one group of products into registers, so the rows' maxima and sums are
// exact over the whole row before any P (no online rescaling moves the
// rounding point); P at ROUND's point is packed to bf16 where it lies (the
// k16 A fragments of the accumulators) and one group of products gives O.
// With NARROW the last block holds at most 16 real keys: its S is one
// m64n16 product per k16 step and its P V one k16 step (208 keys of work
// at 197 tokens instead of 256), in registers of its own, a compile-time
// choice so that no branch chooses between products. Keys past the frame's
// end (zero-filled by TMA) are masked. out: (frames x tokens, heads x 64)
// bf16.
template <int NCONS, int C, int ROUND, int NKB, bool NARROW>
__device__ __forceinline__ void consume_rows(const Smem<NCONS>& sm, const Geometry& g,
                                             float coef, bf16* __restrict__ out,
                                             const Counts<NCONS>& cnt) {
  static_assert(ROUND != kOnline && NKB >= 1 && NKB <= 4 && (!NARROW || NKB >= 2),
                "the study's rounding, <= 256 keys");
  constexpr int WIDE = NARROW ? NKB - 1 : NKB;   // blocks of 64 keys in s
  const int wq = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int total = items_of_block(g) * g.slots;
  for (int f = C, n = cnt.q[C]; f < total; f += NCONS, ++n) {
    const Slot sl = slot_of<NCONS>(g, f);
    const int it = blockIdx.x + sl.item * gridDim.x;
    const int frame = it / g.heads, head = it % g.heads;
    const int b = n & 1, q0 = sl.tile * BM, first = cnt.kv + sl.first;
    mbar_wait(sm.q_full(C, b), (n >> 1) & 1);
    const uint64_t dq = sw128_desc(sm.q_tile(C, b));

    // S = Q K^T over every key block
    float s[WIDE][32], st[8];
#pragma unroll
    for (int j = 0; j < NKB; ++j)
      mbar_wait(sm.kv_full((first + j) % STAGES), ((first + j) / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < WIDE; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[j][i] = 0.f;
      fence_regs(s[j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = 0.f;
    fence_regs(st);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < WIDE; ++j) {
      const uint64_t dk = sw128_desc(sm.kv_tile((first + j) % STAGES, 0));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(s[j], dq + 2 * kk, dk + 2 * kk, kk);
    }
    if constexpr (NARROW) {
      const uint64_t dk = sw128_desc(sm.kv_tile((first + NKB - 1) % STAGES, 0));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss16(st, dq + 2 * kk, dk + 2 * kk, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < WIDE; ++j) fence_regs(s[j]);
    fence_regs(st);
    warp_arrive(sm.q_empty(C, b));   // Q is no longer read

    // P at the mode's point: rows gr and gr + 8 of the warp's 16 (r = i / 2 % 2)
    const int key_last = (NKB - 1) * BK + 2 * t;
    if constexpr (NARROW) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (key_last + (i / 4) * 8 + (i & 1) >= g.tokens) st[i] = -INFINITY;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (key_last + (i / 4) * 8 + (i & 1) >= g.tokens) s[NKB - 1][i] = -INFINITY;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if constexpr (ROUND != kDietNoMax) {
#pragma unroll
      for (int j = 0; j < WIDE; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[j][i]);
      if constexpr (NARROW) {
#pragma unroll
        for (int i = 0; i < 8; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], st[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = -quad_max(m[r]) * coef;
    }
    auto prob = [&](float x, int r) {
      return ROUND == kDietNoMax ? ex2(x * coef) : ex2(fmaf(x, coef, m[r]));
    };
#pragma unroll
    for (int j = 0; j < WIDE; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[j][i] = prob(s[j][i], (i >> 1) & 1);
        l[(i >> 1) & 1] += s[j][i];
      }
    if constexpr (NARROW) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        st[i] = prob(st[i], (i >> 1) & 1);
        l[(i >> 1) & 1] += st[i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
    if constexpr (ROUND == kNormP) {
      const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
      for (int j = 0; j < WIDE; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) s[j][i] *= inv[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 8; ++i) st[i] *= inv[(i >> 1) & 1];
    }
    uint32_t pc[WIDE][BK / 16][4], pt[4];
#pragma unroll
    for (int j = 0; j < WIDE; ++j)
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pc[j][kc][e] = pack_bf16(s[j][8 * kc + 2 * e], s[j][8 * kc + 2 * e + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) pt[e] = NARROW ? pack_bf16(st[2 * e], st[2 * e + 1]) : 0u;

    // O = bf16(P) V over every key block (V's rows 2048 bytes apart a k16 step)
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < WIDE; ++j) fence_regs(pc[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pt[e])::"memory");
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < WIDE; ++j) {
      const uint64_t dv = sw128_desc(sm.kv_tile((first + j) % STAGES, 1));
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs(o, pc[j][kc], dv + kc * ((16 * 128) >> 4));
    }
    if constexpr (NARROW) wgmma_rs(o, pt, sw128_desc(sm.kv_tile((first + NKB - 1) % STAGES, 1)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int j = 0; j < WIDE; ++j) fence_regs(pc[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pt[e])::"memory");
#pragma unroll
    for (int j = 0; j < NKB; ++j) warp_arrive(sm.kv_empty((first + j) % STAGES));

    // "bf16" normalised P before PV; the diet modes divide O by the sum
    const int width = g.heads * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float fac = ROUND == kNormP ? 1.0f : 1.0f / l[r];
      const int row = q0 + wq * 16 + gr + 8 * r;
      if (row >= g.tokens) continue;
      const size_t at = ((size_t)frame * g.tokens + row) * width + head * D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(out + at + jj * 8) =
            __floats2bfloat162_rn(o[4 * jj + 2 * r] * fac, o[4 * jj + 2 * r + 1] * fac);
    }
  }
}

// Consumer c of the study's block, as the compile-time consumer C.
template <int NCONS, int ROUND, int NKB, bool NARROW, int C = 0>
__device__ __forceinline__ void consume_rows_as(int c, const Smem<NCONS>& sm, const Geometry& g,
                                                float coef, bf16* __restrict__ out,
                                                const Counts<NCONS>& cnt) {
  if constexpr (C < NCONS) {
    if (c == C)
      consume_rows<NCONS, C, ROUND, NKB, NARROW>(sm, g, coef, out, cnt);
    else
      consume_rows_as<NCONS, ROUND, NKB, NARROW, C + 1>(c, sm, g, coef, out, cnt);
  }
}

// ---- host ----------------------------------------------------------------------------
// (heads x 64 columns, tokens, frames) bf16 at a row pitch of ld values,
// boxes of 64 x 64 x 1 in the 128-byte swizzle; rows past `tokens` read 0.
inline bool encode(CUtensorMap* map, const void* x, long long ld, int frames, int tokens,
                   int heads) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)tokens, (cuuint64_t)frames};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ld * 2 * tokens};
  const cuuint32_t box[3] = {D, BK, 1}, elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hattn
