// Encoder self-attention on q, k and v given as three base pointers with one
// shared row pitch: one warp-specialised Hopper kernel (TMA loads, wgmma
// products) for every token count, both entries and both output types.
//
// Replaces: dfd_clip_tpu/ops/pallas_attention.py fused_encoder_attention_qkv
// (_make_encoder_qkv_kernel, packed [q | k | v] rows: the packed entry) and
// fused_encoder_attention (_make_encoder_kernel, separate q, k, v: the
// separate entry), and the attention stage of _make_attn_block_kernel and
// _make_full_block_kernel (the packed entry, through ops/encoder_block.py,
// bf16 or f32 out). All compute softmax(q k^T d^-1/2) v per (frame, head)
// with f32 logits; the Pallas kernels round the unnormalised exp to bf16
// before PV and multiply by 1 / sum (the sum of the f32 exps) after it
// (_exp_probs, pallas_attention.py:52-64, 93-99, 124-134). This kernel
// rounds at the same point, with the row maximum subtracted (the port's
// one departure: the TPU kernel clamps the logits at 60 instead).
//
// Bound on an H100 (head_dim 64): a (frame, head) is 4 T^2 64 FLOP on
// 4 x T x 128 bytes moved (q, k, v read once, the bf16 output written
// once): ~130 FLOP a byte at T = 197 (ViT-B/16), ~170 at 257 (ViT-L/14,
// DINOv2 B/14), ~290 at 577 (ViT-L/14@336px), against the card's ~295.
// So device memory bounds it at every path shape, and only if each byte is
// read once: 0.1156 ms at (320 frames, 197, 12 heads), 0.2011 ms at
// (320, 257, 16), 0.4515 ms at (320, 577, 16). At 577 the tensor cores and
// the exp unit come close to the bytes' time as well.
//
// Design. A persistent grid of one block a SM (at most one a work item)
// walks the work items, one (frame, head) each. A block is four
// warpgroups: warpgroup 0 produces (setmaxnreg down to 32 registers), and
// three consumer warpgroups (setmaxnreg up to 160) take a query tile of 64
// rows each and walk its item's keys in blocks of 64. Three consumers hide
// more of each one's chain of product, softmax and product than two (four
// would have 112 registers each, and spill).
// - Loads: TMA with one 3-D tensor map each for q, k and v, (columns,
//   tokens, frames) at the entries' row pitch, boxes of 64 columns (one
//   head, 128 bytes) x 64 rows with the 128-byte swizzle that the wgmma
//   descriptors name. The frame dimension zero-fills rows past a frame's
//   last token (keys there are masked to -inf as well). One producer warp
//   keeps the K/V ring full, another the consumers' Q tiles (two buffers
//   each), each completion on an mbarrier; consumers release a buffer by
//   arriving on its "empty" barrier.
// - K and V are read from device memory once per item: the ring holds
//   STAGES = 10 key blocks (160 KB), so up to 640 tokens (577 included)
//   an item's whole K/V stays resident while each of its query tiles walks
//   it, and a block is released once every tile has read it; the next
//   items' blocks load into the free stages meanwhile (at 197 tokens 2.5
//   items fit). The consumers take the block's query tiles in turn across
//   item boundaries (tile f of the block's sequence goes to consumer
//   f % 3), so none idles at the end of an item (at 197 tokens, 4 tiles an
//   item, groups of three tiles would leave two consumers idle for half of
//   every item). Above 640 tokens the ring refills for each group of
//   three tiles, which walk it together (one schedule, one kernel; the
//   re-reads of an item follow each other and hit L2).
// - Products on wgmma m64n64k16, bf16 in, f32 accumulate: S = Q K^T with
//   both operands K-major from shared memory; O += P V with P taken from
//   registers (the S accumulator of 16 keys packed to bf16 is the A
//   fragment of k16 as it lies, no trip through shared memory) and V
//   MN-major from shared memory through the transpose bit. Where the last
//   key block holds at most 16 real keys (197, 257, 321, 577, 1025 tokens)
//   it takes m64n16k16 for S and one k16 step for PV: 208 keys of work at
//   197 tokens instead of 256, 272 instead of 320 at 257. That choice is a
//   kernel template argument, and the last two blocks are peeled out of the
//   key loop, because ptxas serialises every product of a kernel in which
//   a branch chooses between two products writing the same registers
//   (warning C7520).
// - Within a consumer, block j's P V and block j + 1's S = Q K^T are issued
//   together and the softmax of S_{j+1} runs while P V is on the tensor
//   cores; P_j is packed to bf16 from S_j's registers just before the two
//   products are issued, and the N = 16 tail has an accumulator of its
//   own. (ptxas serialises the products where a plain register copy feeds
//   a product's A operand, or where the narrow S shares the wide one's
//   registers: warnings C7513 and C7511.) The consumers overlap each
//   other; making them take turns at issuing, with named barriers, was
//   slower.
// - Softmax in f32 registers: the row maximum on the raw logits, then
//   2^(s d^-1/2 log2(e) - m) as one fma and one ex2, a running row maximum
//   and f32 sum across key blocks (quad shuffles), O rescaled by
//   2^(m_old - m_new); P rounded to bf16 unnormalised. Keys are masked in
//   the last block only.
// - Epilogue: O x (1 / sum) in f32, stored from the accumulator layout
//   (each quad writes 16 contiguous bf16 bytes, or 32 f32 bytes, of a row)
//   into (frames x tokens, heads x 64), rows past the frame's end skipped;
//   a query tile wholly past the frame's end (the last group above 640
//   tokens) only keeps the barrier protocol.
// Every mbarrier wait traps after ~2^26 polls, so a lost arrival ends the
// launch with an error instead of hanging the card.
//
// Shared memory: 10 x 16 KB K/V + 6 x 8 KB Q (two buffers a consumer) +
// barriers ~ 209 KB, one
// block a SM. The tensor maps are encoded on the host per launch
// (cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links against nothing but the runtime) and passed as
// __grid_constant__ parameters. The mbarrier, TMA, descriptor and wgmma
// helpers live in csrc/hopper.cuh, shared with the GEMMs.
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
using hopper::fence_regs;   // beside the P-fragment overload below

constexpr int D = 64;
constexpr int BM = 64;                  // query rows of a consumer's tile
constexpr int BK = 64;                  // keys of a ring stage
constexpr int STAGES = 10;              // ring stages: an item of <= 640 tokens stays resident
constexpr int NCONS = 3;                // consumer warpgroups, 64 query rows each
constexpr int THREADS = 128 * (NCONS + 1);   // and the producer warpgroup
// setmaxnreg: the producer gives registers to the consumers. A block starts
// with LAUNCH_REGS a thread (65,536 a SM); an increase that the decrease
// does not pay for never returns, so the two must balance.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 160;
static_assert(LAUNCH_REGS - PRODUCER_REGS >= NCONS * (CONSUMER_REGS - LAUNCH_REGS),
              "setmaxnreg would wait for registers that are never freed");
constexpr int TILE_BYTES = BK * D * 2;  // 8 KB: one 64 x 64 bf16 box
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int Q_OFF = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = Q_OFF + 2 * NCONS * TILE_BYTES;
// kv_full, kv_empty (STAGES each), q_full, q_empty (NCONS consumers x 2 buffers)
constexpr int NBARS = 2 * STAGES + 4 * NCONS;
constexpr int SMEM_BYTES = BAR_OFF + NBARS * 8 + 1024;   // + 1024 for the base's alignment
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void fence_regs(uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the kernel ------------------------------------------------------------------
struct Geometry {
  int tokens, heads, items;
  int nkb;        // key blocks of an item (= its query tiles)
  int slots;      // query slots of an item: its tiles, or NCONS a group
  int resident;   // the item's K/V stays in the ring while all its tiles walk it
  int per_item;   // K/V block loads an item takes
};

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
  int first;   // K/V load index of key block 0
};

__device__ __forceinline__ Slot slot_of(const Geometry& g, int f) {
  const int item = f / g.slots, tile = f % g.slots;
  return {item, tile, item * g.per_item + (g.resident ? 0 : tile / NCONS * g.nkb)};
}

__device__ __forceinline__ int slots_of_block(const Geometry& g) {
  return (g.items - blockIdx.x + gridDim.x - 1) / gridDim.x * g.slots;
}

// Shared-memory addresses: the K/V ring, the Q buffers and the barriers.
struct Smem {
  uint32_t base;   // 1024-byte aligned
  __device__ uint32_t kv_tile(int s, int which) const {
    return base + s * STAGE_BYTES + which * TILE_BYTES;
  }
  __device__ uint32_t q_tile(int c, int b) const { return base + Q_OFF + (2 * c + b) * TILE_BYTES; }
  __device__ uint32_t kv_full(int s) const { return base + BAR_OFF + 8u * s; }
  __device__ uint32_t kv_empty(int s) const { return base + BAR_OFF + 8u * (STAGES + s); }
  __device__ uint32_t q_full(int c, int b) const {
    return base + BAR_OFF + 8u * (2 * STAGES + 2 * c + b);
  }
  __device__ uint32_t q_empty(int c, int b) const {
    return base + BAR_OFF + 8u * (2 * STAGES + 2 * NCONS + 2 * c + b);
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

// Consumer C (0 to NCONS - 1) of the block: slots C, C + NCONS, ... A
// template on C, so that every branch around its products
// depends on the geometry and loop counters alone (uniform over the
// warpgroup: the compiler keeps the products asynchronous).
template <int C, bool OUT_F32, bool NARROW>
__device__ __forceinline__ void consume(const Smem& sm, const Geometry& g, float coef,
                                       void* __restrict__ out) {
  const int wq = (threadIdx.x / 32) % 4;       // this warp's 16 rows of the tile
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;       // fragment row group and column pair
  const int total = slots_of_block(g);
  for (int f = C, n = 0; f < total; f += NCONS, ++n) {   // n: this consumer's slots so far
    const Slot sl = slot_of(g, f);
    const int it = blockIdx.x + sl.item * gridDim.x;
    const int frame = it / g.heads, head = it % g.heads;
    const int b = n & 1, q0 = sl.tile * BM, first = sl.first;
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

template <bool OUT_F32, bool NARROW>
__global__ void __launch_bounds__(THREADS, 1)
encoder_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, void* __restrict__ out,
                         const Geometry g, float coef) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const Smem sm{(raw + 1023u) & ~1023u};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.kv_full(s), 1);
      // the 4 warps of each slot that reads the block: all the item's tiles
      // when resident, else the group's NCONS
      mbar_init(sm.kv_empty(s), 4 * (g.resident ? g.nkb : NCONS));
    }
    for (int c = 0; c < NCONS; ++c)
      for (int b = 0; b < 2; ++b) {
        mbar_init(sm.q_full(c, b), 1);
        mbar_init(sm.q_empty(c, b), 4);
      }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: warp 0 the K/V ring, warp 1 the Q tiles --------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      int n = 0;   // K/V block loads so far
      for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
        const int frame = it / g.heads, col = (it % g.heads) * D;
        for (int i = 0; i < g.per_item; ++i, ++n) {
          const int s = n % STAGES, j = i % g.nkb;
          mbar_wait(sm.kv_empty(s), ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(sm.kv_full(s), STAGE_BYTES);
          tma_load(sm.kv_tile(s, 0), &map_k, sm.kv_full(s), col, j * BK, frame);
          tma_load(sm.kv_tile(s, 1), &map_v, sm.kv_full(s), col, j * BK, frame);
        }
      }
    } else if (warp == 1 && lane == 0) {
      const int total = slots_of_block(g);
      for (int f = 0; f < total; ++f) {
        const Slot sl = slot_of(g, f);
        const int it = blockIdx.x + sl.item * gridDim.x;
        const int c = f % NCONS, n = f / NCONS;   // the consumer and its slots so far
        const int b = n & 1;
        mbar_wait(sm.q_empty(c, b), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(sm.q_full(c, b), TILE_BYTES);
        tma_load(sm.q_tile(c, b), &map_q, sm.q_full(c, b), (it % g.heads) * D, sl.tile * BM,
                 it / g.heads);
      }
    }
  } else {
    // ---- the consumer warpgroups, 64 query rows each -------------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    static_assert(NCONS == 3, "one consume<> instantiation a consumer");
    if (warp < 8)
      consume<0, OUT_F32, NARROW>(sm, g, coef, out);
    else if (warp < 12)
      consume<1, OUT_F32, NARROW>(sm, g, coef, out);
    else
      consume<2, OUT_F32, NARROW>(sm, g, coef, out);
  }
}

// (heads x 64 columns, tokens, frames) bf16 at a row pitch of ld values,
// boxes of 64 x 64 x 1 in the 128-byte swizzle; rows past `tokens` read 0.
bool encode(CUtensorMap* map, const void* x, long long ld, int frames, int tokens, int heads) {
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

int launch(const void* q, const void* k, const void* v, long long ld, void* out, int frames,
           int tokens, int heads, float scale, int out_f32, void* stream) {
  const long long items = (long long)frames * heads;
  if (tokens < 1 || frames < 1 || heads < 1 || items > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, ld, frames, tokens, heads) || !encode(&mk, k, ld, frames, tokens, heads) ||
      !encode(&mv, v, ld, frames, tokens, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.tokens = tokens;
  g.heads = heads;
  g.items = static_cast<int>(items);
  g.nkb = (tokens + BK - 1) / BK;
  const int groups = (g.nkb + NCONS - 1) / NCONS;   // of NCONS query tiles
  g.resident = g.nkb <= STAGES;
  g.per_item = g.resident ? g.nkb : groups * g.nkb;
  g.slots = g.resident ? g.nkb : groups * NCONS;
  // two key blocks or more, the last of <= 16 real keys: its N = 16 products
  const bool narrow = g.nkb >= 2 && tokens - (g.nkb - 1) * BK <= 16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block's load and slot counters are ints
  const long long per_block = (items + sms - 1) / sms;
  if (per_block * g.per_item > 0x7fffffffLL || per_block * g.slots > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = out_f32 ? (narrow ? encoder_attention_kernel<true, true>
                                  : encoder_attention_kernel<true, false>)
                        : (narrow ? encoder_attention_kernel<false, true>
                                  : encoder_attention_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, out, g, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The separate entry: out[frames * tokens, heads * 64] (f32 when out_f32,
// else bf16) = attention over bf16 q, k and v whose row r of frame f starts
// at x + (f * tokens + r) * ld, heads x 64 values each. The three may be
// column blocks of one packed buffer (ld = 3 x heads x 64) or contiguous
// tensors (ld = heads x 64). 16-byte aligned bases and rows (the wrapper
// checks; TMA needs them).
extern "C" int dfd_encoder_attention(const void* q, const void* k, const void* v, long long ld,
                                     void* out, int frames, int tokens, int heads, float scale,
                                     int out_f32, void* stream) {
  return launch(q, k, v, ld, out, frames, tokens, heads, scale, out_f32, stream);
}

// The packed entry: the same over qkv[frames * tokens, 3 * heads * 64],
// rows [q | k | v].
extern "C" int dfd_encoder_attention_packed(const void* qkv, void* out, int frames, int tokens,
                                            int heads, float scale, int out_f32, void* stream) {
  const long long width = (long long)heads * D;
  const bf16* base = static_cast<const bf16*>(qkv);
  return launch(base, base + width, base + 2 * width, 3 * width, out, frames, tokens, heads,
                scale, out_f32, stream);
}
