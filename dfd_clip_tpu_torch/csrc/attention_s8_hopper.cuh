// The int8 encoder attention's body (_attn_int8_cols) on the bf16 attention's
// producer / consumer frame (csrc/attention_hopper.cuh): the K/V and Q
// producers are that frame's, two producer warps quantise each key block
// once, and NCONS consumer warpgroups take 64-row query tiles through both
// products on int8 wgmma. The per-layer kernel (csrc/encoder_attention_s8.cu,
// whose header describes the design) runs it once, the whole-encoder tower
// (csrc/encoder_tower.cuh) once an attention stage, both with two consumer
// warpgroups. A query tile's arithmetic does not depend on NCONS, nor on
// whether its item's key blocks stay resident, so both callers give the same
// bits.
// The ring, Q-buffer and ready-barrier counters carry from one call to the
// next (hattn::Counts), so the mbarriers keep their phases across the
// tower's stages.
#pragma once

#include "attention_hopper.cuh"

namespace attn_s8 {

using namespace hopper;
using hattn::BK;
using hattn::BM;
using hattn::Counts;
using hattn::D;
using hattn::Geometry;
using hattn::STAGES;

constexpr int QUANT_WARP = 2;                 // producer warps 2 and 3 quantise
constexpr int QUANT_THREADS = 64;             // a K row and a half channel pair each
constexpr int SCALE_BYTES = 2 * BK * 4;       // a stage's sk (64 keys) and sv (64 channels)
constexpr int ROW_LANES = QUANT_THREADS / 8;  // V's maxima: 8 channels a thread, 8 row lanes
constexpr int MAX_BYTES = 2 * ROW_LANES * D * 4;   // their partial maxima, for 2 items

template <int NCONS>
struct Layout {
  // hattn's K/V ring and Q buffers, then each stage's scales, then the
  // quantisers' partial maxima
  static constexpr int SCALE_OFF = hattn::Layout<NCONS>::DATA_BYTES;
  static constexpr int MAX_OFF = SCALE_OFF + STAGES * SCALE_BYTES;
  static constexpr int DATA_BYTES = MAX_OFF + MAX_BYTES;
  // hattn's barriers, then k_ready and v_ready (STAGES each)
  static constexpr int BAR_BYTES = hattn::Layout<NCONS>::BAR_BYTES + 2 * STAGES * 8;
};

// hattn's schedule; above the ring's 640 tokens a group of NCONS query tiles
// walks its item's key blocks twice (the row maxima, then P and PV), so an
// item takes two loads a key block a group.
template <int NCONS>
__host__ __device__ inline Geometry geometry(int frames, int tokens, int heads) {
  Geometry g = hattn::geometry<NCONS>(frames, tokens, heads);
  if (!g.resident) g.per_item *= 2;
  return g;
}

template <int NCONS>
struct Smem {
  hattn::Smem<NCONS> a;   // the K/V ring, the Q buffers and their barriers
  uint32_t ready;         // 2 x STAGES barriers: a stage's int8 K is in; its V^T is in
  unsigned char* data;    // the generic address of a.base
  __device__ unsigned char* ptr(uint32_t addr) const { return data + (addr - a.base); }
  __device__ uint32_t k_ready(int s) const { return ready + 8u * s; }
  __device__ uint32_t v_ready(int s) const { return ready + 8u * (STAGES + s); }
  __device__ float* sk(int s) const {
    return reinterpret_cast<float*>(data + Layout<NCONS>::SCALE_OFF + s * SCALE_BYTES);
  }
  __device__ float* sv(int s) const { return sk(s) + BK; }
  // the partial channel maxima of row lane l for items of parity p
  __device__ float* vmax(int p, int l) const {
    return reinterpret_cast<float*>(data + Layout<NCONS>::MAX_OFF) + (p * ROW_LANES + l) * D;
  }
  // One thread, once a launch, after a.init (one arrival a quantiser warp).
  __device__ void init_ready() const {
    for (int s = 0; s < 2 * STAGES; ++s) mbar_init(ready + 8u * s, QUANT_THREADS / 32);
    mbar_fence_init();
  }
};

// d (64 x 32 s32) (+)= A (64 x 32 int8, K-major in shared memory) x B (32 x 32,
// K-major); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_ss32(int (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64 s32) (+)= A (64 x 32 int8 in registers: each warp's 16 rows as
// the m16n8k32 A fragment) x B (32 x 64, K-major in shared memory);
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Byte offset of 16-byte chunk c of row r in a 1024-byte aligned tile of
// 128-byte rows in the 128-byte swizzle (TMA's and the descriptors').
__device__ __forceinline__ int sw(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Position of key k (0 .. 31 of a 32-key step) in a V^T row. The PV product
// takes P's A fragment straight from the logits' accumulator registers,
// where a thread holds keys 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16, while the
// fragment holds k = 4t .. 4t + 3: V^T stores its keys in that order (the
// int32 sums are exact, so the order of k is free).
__host__ __device__ constexpr int kpos(int k) {
  return (k & ~15) + (k % 8) / 2 * 4 + (k % 16) / 8 * 2 + k % 2;
}

// The low bytes of four registers as the bytes of one, the first lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
}

// rint(x) (half to even) for |x| < 2^22 as the low byte of the result: x +
// 1.5 x 2^23, rounded to nearest even where the grid is 1, is 1.5 x 2^23 +
// rint(x), whose low byte is rint(x)'s two's complement byte. The f32 -> int
// conversion runs at a quarter of the FMA pipes' rate on an H100, and P's
// quantisation took one a logit; this add takes the full-rate pipe.
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.0f));
}

// v (finite) times mul = 127 / s with |v| <= s, rounded half to even (the
// _quant_rows rounding), as the low byte of the result: |v * mul| < 127.5,
// so its clip to [-127, 127] never binds.
__device__ __forceinline__ uint32_t q8(float v, float mul) { return rint_bits(__fmul_rn(v, mul)); }

// Running maxima m of two bf16 magnitudes (as bits, half by half) taken
// over the halves of w: a finite bf16's magnitude orders as its bits with
// the sign cleared.
__device__ __forceinline__ uint32_t abs_max2(uint32_t m, uint32_t w) {
  return __vmaxu2(m, w & 0x7fff7fffu);
}

// The two bf16 values of a 32-bit word as f32.
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 32 int8 values as eight registers: value b of the 32 in byte b % 4 of
// register b / 4, each placed by one byte permute (b known at compile time).
struct Int8x32 {
  uint32_t w[8];
  __device__ __forceinline__ Int8x32() {
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = 0u;
  }
  __device__ __forceinline__ void set(int b, uint32_t q) {   // q's low byte
    const int p = b % 4;
    w[b / 4] = __byte_perm(w[b / 4], q,
                           (0x3210u & ~(0xFu << (4 * p))) | (4u << (4 * p)));
  }
  __device__ __forceinline__ void store(unsigned char* lo, unsigned char* hi) const {
    *reinterpret_cast<uint4*>(lo) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(hi) = make_uint4(w[4], w[5], w[6], w[7]);
  }
};

// ---- the quantisers: producer warps 2 and 3 ----------------------------------------
// Row i of a stage's tile 0 in place: its raw K row (64 bf16, TMA's swizzled
// 128 bytes) -> int8 in the row's bytes 0 .. 63, s = max|k| + 1e-8, q =
// clip(round(k * (127 / s))). Each half's int8 chunks land where raw chunks
// already read lay (the row is read twice, to keep the thread's registers
// few). Returns s.
__device__ __forceinline__ float quant_k_row(unsigned char* tile, int i) {
  uint32_t mw = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 u = *reinterpret_cast<const uint4*>(tile + sw(i, c));
    mw = abs_max2(abs_max2(abs_max2(abs_max2(mw, u.x), u.y), u.z), u.w);
  }
  const float s = __fadd_rn(fmaxf(bf_lo(mw), bf_hi(mw)), 1e-8f), mul = 127.0f / s;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    Int8x32 pk;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 u = *reinterpret_cast<const uint4*>(tile + sw(i, 4 * h + c));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pk.set(8 * c + 2 * e, q8(bf_lo(w[e]), mul));
        pk.set(8 * c + 2 * e + 1, q8(bf_hi(w[e]), mul));
      }
    }
    pk.store(tile + sw(i, 2 * h), tile + sw(i, 2 * h + 1));
  }
  return s;
}

// Channels 2 cp and 2 cp + 1 of key r of a raw V tile (64 keys x 64 bf16,
// swizzled): one 32-bit word.
__device__ __forceinline__ uint32_t v_pair(const unsigned char* tile, int r, int cp) {
  return *reinterpret_cast<const uint32_t*>(tile + sw(r, cp >> 2) + (cp & 3) * 4);
}

// A quantiser thread's share of V^T: channels 2 cp and 2 cp + 1 over keys
// 32 kh .. 32 kh + 31 of each block (kh: its warp). The two channels are
// quantised with mul = 127 / sv, their keys in kpos order, into bytes 64 +
// 32 kh .. of V^T rows 2 cp and 2 cp + 1 (rows of tile kt, whose K halves
// are quantised already).
struct VPart {
  int cp, kh;
  __device__ __forceinline__ void transpose(const unsigned char* vt, unsigned char* kt,
                                            const float (&mul)[2]) const {
    Int8x32 a, b;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t w = v_pair(vt, 32 * kh + k, cp);
      a.set(kpos(k), q8(bf_lo(w), mul[0]));
      b.set(kpos(k), q8(bf_hi(w), mul[1]));
    }
    a.store(kt + sw(2 * cp, 4 + 2 * kh), kt + sw(2 * cp, 5 + 2 * kh));
    b.store(kt + sw(2 * cp + 1, 4 + 2 * kh), kt + sw(2 * cp + 1, 5 + 2 * kh));
  }
};

// The two quantiser warps over the block's items: each load's K rows in place
// with their scales (then k_ready), and (mode "1", a load that PV reads) V's
// channels, scaled per channel over all the frame's tokens, transposed
// beside them (then v_ready; every load completes both barriers once). V's
// channel maxima come first, from device memory (qkv: the packed rows, ld
// values a row; 16-byte loads, 8 channels a thread over 8 row lanes, their
// partial maxima meeting in shared memory, two buffers by item parity so
// that a warp an item ahead never overwrites what the other still reads):
// so an item's V^T follows each block as it lands, and the second pass
// need not wait for the item's last block (nor, when the item is resident,
// for the previous item to release the whole ring). TMA's read of V then
// mostly hits L2. A named barrier of the 64 threads orders every K row of a
// load before its V^T writes, which overwrite raw K bytes other threads
// read.
template <int NCONS, bool QK>
__device__ __forceinline__ void quantise(const Smem<NCONS>& sm, const Geometry& g,
                                         const bf16* __restrict__ qkv, long long ld,
                                         const Counts<NCONS>& cnt) {
  const int i = threadIdx.x % 128 - 32 * QUANT_WARP;
  const VPart vp{i % 32, i / 32};
  auto sync = [] { named_barrier(NCONS + 1, QUANT_THREADS); };
  float sv[2] = {0.f, 0.f}, mul[2] = {0.f, 0.f};
  int n = cnt.kv, parity = 0;
  for (int it = blockIdx.x; it < g.items; it += gridDim.x, parity ^= 1) {
    if (!QK) {
      // channels 8 (i % 8) .. + 7 over rows i / 8, i / 8 + 8, ...
      const bf16* v = qkv + (size_t)(it / g.heads) * g.tokens * ld + 2 * g.heads * D +
                      (it % g.heads) * D + 8 * (i % 8);
      uint32_t m[4] = {0u, 0u, 0u, 0u};   // |x|'s bits, two channels a word
#pragma unroll 4
      for (int r = i / 8; r < g.tokens; r += ROW_LANES) {
        const uint4 u = *reinterpret_cast<const uint4*>(v + (size_t)r * ld);
        m[0] = abs_max2(m[0], u.x);
        m[1] = abs_max2(m[1], u.y);
        m[2] = abs_max2(m[2], u.z);
        m[3] = abs_max2(m[3], u.w);
      }
      float* mine = sm.vmax(parity, i / 8) + 8 * (i % 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[2 * e] = bf_lo(m[e]);
        mine[2 * e + 1] = bf_hi(m[e]);
      }
      sync();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = 0.f;
#pragma unroll
        for (int l = 0; l < ROW_LANES; ++l) mx = fmaxf(mx, sm.vmax(parity, l)[2 * vp.cp + c]);
        sv[c] = __fadd_rn(mx, 1e-8f);
        mul[c] = 127.0f / sv[c];
      }
    }
    for (int k = 0; k < g.per_item; ++k, ++n) {
      const int s = n % STAGES;
      mbar_wait(sm.a.kv_full(s), (n / STAGES) & 1);
      unsigned char* kt = sm.ptr(sm.a.kv_tile(s, 0));
      sm.sk(s)[i] = quant_k_row(kt, i);
      fence_proxy_async_shared();
      warp_arrive(sm.k_ready(s));
      if (!QK && (g.resident || k % (2 * g.nkb) >= g.nkb)) {   // a load that PV reads
        sync();
        vp.transpose(sm.ptr(sm.a.kv_tile(s, 1)), kt, mul);
        if (vp.kh == 0) {
          sm.sv(s)[2 * vp.cp] = sv[0];
          sm.sv(s)[2 * vp.cp + 1] = sv[1];
        }
        fence_proxy_async_shared();
      }
      warp_arrive(sm.v_ready(s));
    }
  }
}

// A half block's P as the PV product's A fragments: one int8 k32 step, or
// (QK) two bf16 k16 steps.
template <bool QK>
struct PFrag {
  static constexpr int KS = QK ? 2 : 1;
  uint32_t r[KS][4];
};

// ---- the consumers ---------------------------------------------------------------------
// The consumer's raw Q tile (64 rows of 64 bf16) quantised in place, per row:
// s = max|q| + 1e-8, q = clip(round(q * (127 / s))) into each row's bytes
// 0 .. 63; lanes 2r and 2r + 1 of warp w take row 16 w + r, so each warp
// quantises the rows whose A fragments it holds. cq: sq * coef_qk of rows gr
// and gr + 8 of this warp.
__device__ __forceinline__ void quant_q(unsigned char* tile, float coef_qk, float (&cq)[2]) {
  const int lane = threadIdx.x % 32, r = (threadIdx.x % 128) / 2, h = lane & 1;
  float v[32];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    load8(reinterpret_cast<const bf16*>(tile + sw(r, 4 * h + c)), v + 8 * c);
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) m = fmaxf(m, fabsf(v[e]));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));   // both halves read before either writes
  const float s = __fadd_rn(m, 1e-8f), mul = 127.0f / s;
  Int8x32 pk;
#pragma unroll
  for (int e = 0; e < 32; ++e) pk.set(e, q8(v[e], mul));
  __syncwarp();
  pk.store(tile + sw(r, 2 * h), tile + sw(r, 2 * h + 1));
  const int gr = lane / 4;
  cq[0] = __fmul_rn(__shfl_sync(0xffffffffu, s, 2 * gr), coef_qk);
  cq[1] = __fmul_rn(__shfl_sync(0xffffffffu, s, 2 * gr + 16), coef_qk);
}

// Consumer C (0 .. NCONS - 1) of the block: slots C, C + NCONS, ... (the
// slots of hattn::slot_of). A template on C and on the mode, so that every
// branch around its products depends on the geometry and loop counters
// alone (uniform over the warpgroup: ptxas keeps the products
// asynchronous). out: (frames x tokens, heads x 64) f32. ZERO: mode "1"'s PV
// accumulator is zeroed before its first step, as mode "qk"'s always is,
// rather than overwritten by it (the same values). The per-layer kernel
// overwrites: zeroing instructions while a product runs make ptxas
// serialise its products (C7515). The tower zeroes: ptxas serialises its
// products anyway (C7512), and there the accumulator left unset spilled
// more and ran slower on an H100.
template <int NCONS, int C, bool QK, bool ZERO>
__device__ __forceinline__ void consume(const Smem<NCONS>& sm, const Geometry& g, float coef_qk,
                                        float* __restrict__ out, const Counts<NCONS>& cnt) {
  const int wq = (threadIdx.x / 32) % 4;    // this warp's 16 rows of the tile
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;    // fragment row group and column pair
  const int total = hattn::items_of_block(g) * g.slots;
  const float sp = __fadd_rn(1.0f, 1e-8f), pmul = 127.0f / sp;   // P's scale: max p = exp(0)
  using O = std::conditional_t<QK, float, int>;
  for (int f = C, n = cnt.q[C]; f < total; f += NCONS, ++n) {   // n: this consumer's slots
    const int item = f / g.slots, tile = f % g.slots;
    const int it = blockIdx.x + item * gridDim.x;
    const int frame = it / g.heads, head = it % g.heads;
    // loads of the tile's first pass and of its second (the same when resident)
    const int first = cnt.kv + item * g.per_item + (g.resident ? 0 : tile / NCONS * 2 * g.nkb);
    const int second = g.resident ? first : first + g.nkb;
    const int b = n & 1, q0 = tile * BM;
    const uint32_t qt = sm.a.q_tile(C, b);
    mbar_wait(sm.a.q_full(C, b), (n >> 1) & 1);
    if (q0 >= g.tokens) {
      // a tile past the frame's end (the last group above 640 tokens): keep
      // the protocol only
      warp_arrive(sm.a.q_empty(C, b));
      for (int j = 0; j < 2 * g.nkb; ++j) {
        const int ld = first + j;
        mbar_wait(sm.k_ready(ld % STAGES), (ld / STAGES) & 1);
        mbar_wait(sm.v_ready(ld % STAGES), (ld / STAGES) & 1);
        warp_arrive(sm.a.kv_empty(ld % STAGES));
      }
      continue;
    }
    float cq[2];
    quant_q(sm.ptr(qt), coef_qk, cq);
    fence_proxy_async_shared();
    named_barrier(1 + C, 128);   // the warpgroup's int8 Q rows are in
    const uint64_t dq = sw128_desc(qt);
    // A key block's S = Q K^T in two halves of 32 keys, lo and hi, each
    // m64n32 (two k32 steps): while one half's f32 work runs, the other's
    // product (and a PV step) is on the tensor cores. Every step issues and
    // waits alike, so the wait counts are compile-time constants.
    int lo[16], hi[16];
    auto qk = [&](int (&d)[16], int ld, int h, bool pv_next) {
      const int s = ld % STAGES;
      mbar_wait(!QK && pv_next ? sm.v_ready(s) : sm.k_ready(s), (ld / STAGES) & 1);
      const uint64_t dk = sw128_desc(sm.a.kv_tile(s, 0)) + h * ((32 * 128) >> 4);
      fence_regs(d);
      wgmma_fence();
      wgmma_s8_ss32(d, dq, dk, 0);
      wgmma_s8_ss32(d, dq + 2, dk + 2, 1);
      wgmma_commit();
      fence_regs(d);
    };
    // the logits of d's element i (row (i >> 1) & 1, key 8 (i >> 2) + 2t +
    // (i & 1) of the half): (acc * (sq * coef_qk)) * sk, in the plain
    // version's order, none fused
    auto logit = [&](const int (&d)[16], int i, float2 skv) {
      return __fmul_rn(__fmul_rn(static_cast<float>(d[i]), cq[(i >> 1) & 1]),
                       (i & 1) ? skv.y : skv.x);
    };

    // pass 1: the row maxima of rows gr and gr + 8 (two partial maxima a row,
    // by key group parity). last: the frame's last block, whose keys past
    // the end do not count (a group of 8 wholly past it is skipped,
    // uniformly over the warpgroup).
    float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
    auto maxima = [&](const int (&d)[16], int ld, int j, int h, bool last) {
      const float* sk = sm.sk(ld % STAGES) + 32 * h;
      const int key0 = j * BK + 32 * h;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (last && key0 + 8 * nb >= g.tokens) break;
        const float2 skv = *reinterpret_cast<const float2*>(sk + 8 * nb + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = logit(d, 4 * nb + e, skv);
          if (!last || key0 + 8 * nb + 2 * t + (e & 1) < g.tokens)
            m[e >> 1][nb & 1] = fmaxf(m[e >> 1][nb & 1], l);
        }
      }
    };
    // Block j, its lo half's product in flight: the hi half's, then the
    // next block's lo half (MORE) beside the maxima.
    auto step1 = [&](int j, auto more) {
      constexpr bool MORE = decltype(more)::value;
      const int ld = first + j;
      qk(hi, ld, 1, false);
      wgmma_wait<1>();
      fence_regs(lo);
      maxima(lo, ld, j, 0, !MORE);
      if constexpr (MORE) {
        qk(lo, ld + 1, 0, false);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(hi);
      maxima(hi, ld, j, 1, !MORE);
      if (!g.resident) warp_arrive(sm.a.kv_empty(ld % STAGES));
    };
    using Yes = std::true_type;
    using No = std::false_type;
    qk(lo, first, 0, false);
    for (int j = 0; j + 1 < g.nkb; ++j) step1(j, Yes{});
    step1(g.nkb - 1, No{});
    m[0][0] = quad_max(fmaxf(m[0][0], m[0][1]));
    m[1][0] = quad_max(fmaxf(m[1][0], m[1][1]));

    // pass 2: the same logits, p = exp(l - max) (0 past the frame's end), the
    // row sums (two partial sums a row, by key group parity), and the half's
    // P as the PV product's A fragments: mode "1" P's int8 values, one k32
    // step (keys 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16, the kpos order; rows
    // gr in registers 0 and 2, gr + 8 in 1 and 3), mode "qk" bf16(p), two
    // k16 steps. The values go to registers of their own, never back into
    // the product's accumulator (ptxas would serialise the products).
    float lsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    using Frag = PFrag<QK>;
    constexpr int KS = Frag::KS;
    Frag pc_lo, pc_hi;
    // (last: the frame's last block; a constant where the lambdas are inlined)
    auto probs = [&](const int (&d)[16], int ld, int j, int h, bool last, Frag& pc) {
      const float* sk = sm.sk(ld % STAGES) + 32 * h;
      const int key0 = j * BK + 32 * h;
      float p[16];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (last && key0 + 8 * nb >= g.tokens) {   // a key group wholly past the end
#pragma unroll
          for (int e = 0; e < 4; ++e) p[4 * nb + e] = 0.f;
          continue;
        }
        const float2 skv = *reinterpret_cast<const float2*>(sk + 8 * nb + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = logit(d, 4 * nb + e, skv);
          p[4 * nb + e] = !last || key0 + 8 * nb + 2 * t + (e & 1) < g.tokens
                              ? expf(l - m[e >> 1][0])
                              : 0.f;
          lsum[e >> 1][nb & 1] += p[4 * nb + e];
        }
      }
#pragma unroll
      for (int kc = 0; kc < KS; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (QK) {
            pc.r[kc][e] = pack_bf16(p[8 * kc + 2 * e], p[8 * kc + 2 * e + 1]);
          } else {
            // p <= 1 and pmul = 127, so _quant_rows' clip never binds
            const int base = 8 * (e >> 1) + 2 * (e & 1);
            pc.r[kc][e] = pack4(rint_bits(__fmul_rn(p[base], pmul)),
                                rint_bits(__fmul_rn(p[base + 1], pmul)),
                                rint_bits(__fmul_rn(p[base + 4], pmul)),
                                rint_bits(__fmul_rn(p[base + 5], pmul)));
          }
        }
    };
    O o[32];
    if constexpr (QK || ZERO) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0;
    }
    auto fence_pc = [](Frag& pc) {
#pragma unroll
      for (int kc = 0; kc < KS; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pc.r[kc][e])::"memory");
    };
    // O += P_half V_half of load ld: mode "1" V^T's bytes 64 + 32 h .. of
    // tile 0 (one k32 step), mode "qk" V's rows 32 h .. of tile 1 (two k16
    // steps, 16 rows apart)
    // (o is not fenced here: nothing but the PV steps touches it before the
    // last wait, and a fence on it while a PV step is in flight would make
    // ptxas serialise the products)
    auto pv = [&](Frag& pc, int ld, int h, bool accumulate) {
      const int s = ld % STAGES;
      fence_pc(pc);
      wgmma_fence();
      if constexpr (QK) {
        const uint64_t dv = sw128_desc(sm.a.kv_tile(s, 1)) + h * ((32 * 128) >> 4);
#pragma unroll
        for (int kc = 0; kc < KS; ++kc)
          hattn::wgmma_rs(o, pc.r[kc], dv + kc * ((16 * 128) >> 4));
      } else {
        wgmma_s8_rs(o, pc.r[0], sw128_desc(sm.a.kv_tile(s, 0)) + 4 + 2 * h, accumulate);
      }
      wgmma_commit();
      fence_pc(pc);
    };
    // Block j, its lo half's product in flight (and the previous block's
    // two PV steps): the hi half's product, lo's P and PV step, the next
    // block's lo product (MORE), hi's P and PV step. Groups in flight at
    // each wait: see the counts.
    auto step2 = [&](int j, auto more) {
      constexpr bool MORE = decltype(more)::value;
      constexpr bool LAST = !MORE;
      const int ld = second + j;
      qk(hi, ld, 1, true);
      wgmma_wait<2>();   // lo's product (and PV lo of block j - 1) done
      fence_regs(lo);
      probs(lo, ld, j, 0, LAST, pc_lo);
      pv(pc_lo, ld, 0, ZERO || j > 0);
      if constexpr (MORE) {
        qk(lo, ld + 1, 0, true);
        wgmma_wait<2>();   // hi's product and PV hi of block j - 1 done
      } else {
        wgmma_wait<1>();
        warp_arrive(sm.a.q_empty(C, b));   // Q is no longer read
      }
      fence_regs(hi);
      if (j > 0) warp_arrive(sm.a.kv_empty((ld - 1) % STAGES));   // block j - 1's PV done
      probs(hi, ld, j, 1, LAST, pc_hi);
      pv(pc_hi, ld, 1, true);
    };
    qk(lo, second, 0, true);
    wgmma_commit();   // an empty group, so that block 0 waits as the others do
    for (int j = 0; j + 1 < g.nkb; ++j) step2(j, Yes{});
    step2(g.nkb - 1, No{});
    wgmma_wait<0>();
    fence_regs(o);

    // mode "1": (Pi Vi) * (sp * (1 / sum p) / 127^2) * sv; "qk": O * (1 / sum p);
    // rows gr and gr + 8 of this warp's 16
    const int width = g.heads * D;
    const int held = (second + g.nkb - 1) % STAGES;
    const float* sv = sm.sv(held);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rsum = 1.0f / quad_sum(lsum[r][0] + lsum[r][1]);
      const int row = q0 + wq * 16 + gr + 8 * r;
      if (row >= g.tokens) continue;
      const float cr = QK ? rsum : __fdiv_rn(__fmul_rn(sp, rsum), 16129.0f);
      float* dst = out + ((size_t)frame * g.tokens + row) * width + head * D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        float2 v;
        if constexpr (QK) {
          v = make_float2(__fmul_rn(o[4 * jj + 2 * r], cr), __fmul_rn(o[4 * jj + 2 * r + 1], cr));
        } else {
          const float2 s2 = *reinterpret_cast<const float2*>(sv + 8 * jj + 2 * t);
          v = make_float2(
              __fmul_rn(__fmul_rn(static_cast<float>(o[4 * jj + 2 * r]), cr), s2.x),
              __fmul_rn(__fmul_rn(static_cast<float>(o[4 * jj + 2 * r + 1]), cr), s2.y));
        }
        *reinterpret_cast<float2*>(dst + jj * 8) = v;
      }
    }
    warp_arrive(sm.a.kv_empty(held));
  }
}

// Consumer c of the block (its warpgroup's index less one), as the
// compile-time consumer C that consume() takes.
template <int NCONS, bool QK, bool ZERO, int C = 0>
__device__ __forceinline__ void consume_as(int c, const Smem<NCONS>& sm, const Geometry& g,
                                           float coef_qk, float* __restrict__ out,
                                           const Counts<NCONS>& cnt) {
  if constexpr (C < NCONS) {
    if (c == C)
      consume<NCONS, C, QK, ZERO>(sm, g, coef_qk, out, cnt);
    else
      consume_as<NCONS, QK, ZERO, C + 1>(c, sm, g, coef_qk, out, cnt);
  }
}

// The producer warpgroup's roles: warp 0 the K/V ring, warp 1 the Q tiles
// (hattn's producers), warps 2 and 3 the quantisers. qkv: the packed rows
// the tensor maps view, ld values a row.
template <int NCONS, bool QK>
__device__ __forceinline__ void produce(const Smem<NCONS>& sm, const Geometry& g,
                                        const CUtensorMap* map_q, const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, const bf16* __restrict__ qkv,
                                        long long ld, const Counts<NCONS>& cnt) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  if (warp == 0) {
    if (lane == 0) hattn::produce_kv(sm.a, g, map_k, map_v, cnt);
  } else if (warp == 1) {
    if (lane == 0) hattn::produce_q(sm.a, g, map_q, cnt);
  } else {
    quantise<NCONS, QK>(sm, g, qkv, ld, cnt);
  }
}

}  // namespace attn_s8
