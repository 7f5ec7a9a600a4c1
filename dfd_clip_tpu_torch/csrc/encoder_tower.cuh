// The whole-encoder tower's kernel: its stages, the walk of each role and
// the launch's shared-memory layout. The design is described in
// csrc/encoder_tower.cu, which holds the entry points; the four
// instantiations (bf16 or int8, with or without the attention's N = 16
// tail) are compiled in encoder_tower_{bf16,s8}{,_narrow}.cu.
#pragma once

#include "attention_hopper.cuh"
#include "attention_s8_hopper.cuh"
#include "gemm_ops.cuh"
#include "rows.cuh"

namespace tower {

using hgemm::BF16Op;
using hgemm::S8Op;
using hopper::WATCHDOG;

constexpr int THREADS = hgemm::THREADS;            // a producer and two consumer warpgroups
constexpr int BN = 256;                            // the products' tile width
constexpr int CL = hgemm::Layout<BN>::CLUSTER;     // CTAs a cluster
constexpr int NCONS = hgemm::NCONS;                // consumer warpgroups, the attention's too
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;
static_assert(hgemm::THREADS == 128 * (NCONS + 1), "one block shape for every stage");

// Shared memory: the barriers (the GEMM frame's, then the attention's, then
// the int8 attention's ready barriers) and the current product's parameters
// (PARAMS_OFF) in BAR_BYTES below the data, which starts 1024-byte aligned;
// the data is the largest of the stages' (the GEMM ring, staging tile and
// column operands; the attention's K/V ring and Q buffers, with the int8
// attention's scales).
constexpr int BAR_BYTES = 1024;
constexpr int GEMM_BARS = hgemm::Layout<BN>::BAR_BYTES;
constexpr int PARAMS_OFF = 512;
static_assert(GEMM_BARS + attn_s8::Layout<NCONS>::BAR_BYTES <= PARAMS_OFF, "barriers");
constexpr int GEMM_DATA = hgemm::Layout<BN>::BAR_OFF;
constexpr int ATTN_DATA = hattn::Layout<NCONS>::DATA_BYTES;
constexpr int S8_DATA = attn_s8::Layout<NCONS>::DATA_BYTES;
constexpr int SLACK = BAR_BYTES + 1024;
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may use

// One layer's parameters (models/clip_vit.py's per-layer dicts).
struct LayerW {
  const void* w[4];     // qkv, out-proj, c_fc, c_proj: bf16 (K, N) row-major, or int8 (N, K)
  const float* ws[4];   // the int8 weights' per-channel scales (N,); unused in bf16
  const float* b[4];    // biases (N,), f32
  const float* ln[4];   // ln_1 scale, ln_1 shift, ln_2 scale, ln_2 shift (W,), f32
};

enum : int { kQkv = 0, kOut = 1, kFc = 2, kProj = 3 };

struct TowerArgs {
  // the products' A operands over the chunk's scratch: bf16 y, att, mid;
  // int8 aq at a pitch of W (in_w and att) and of the MLP width (mid)
  CUtensorMap map_in;     // LN1 / LN2 output: qkv and c_fc
  CUtensorMap map_att;    // the attention output (its int8 rows): out-proj
  CUtensorMap map_mid;    // the MLP intermediate (its int8 rows): c_proj
  CUtensorMap map_q, map_k, map_v;   // the attention's (W, tokens, chunk) views of qkv
  const CUtensorMap* wmaps;   // 4 a layer: the weights (the last layer's qkv: its K/V columns)
  const LayerW* layers;       // layers 0 .. last
  unsigned* barrier;          // the grid barrier's counter, 0 at launch
  unsigned long long* clock;  // or null: [0] readings so far, then %globaltimer at the
                              // launch's start and as each grid barrier completes (block 0)
  const bf16* h0;         // (frames * tokens, W): the post-embed residual stream
  bf16* k;                // (nsel, frames, t_out, W) exports
  bf16* v;
  int frames, tokens, width, heads, hidden;
  int first, last, lo, t_out, chunk;
  int attn;               // 0: softmax attention in bf16; 1: _attn_int8_cols; 2: its "qk" mode
  float coef;             // d^-1/2 log2(e): the bf16 attention's logit factor
  float coef_qk;          // d^-1/2 / 127^2
  // one chunk's scratch, chunk * tokens rows
  bf16* h;                // the residual stream between layers
  bf16* qkv;              // (rows, 3W)
  void* att;              // (rows, W): bf16, or f32 on the int8 tower
  float* hmid;            // (rows, W)
  void* mid;              // (rows, hidden): bf16, or f32 on the int8 tower
  bf16* y;                // (rows, W): the LayerNorm output (bf16 tower)
  int8_t* aq;             // (rows, hidden): int8 activations (int8 tower)
  float* as;              // (rows,): their scales
};

// The stage clock: block 0's thread 0 appends a %globaltimer reading.
__device__ __forceinline__ void clock_reading(unsigned long long* clock) {
  if (clock == nullptr || blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  const unsigned long long i = clock[0];
  clock[1 + i] = t;
  clock[0] = i + 1;
}

// The grid barrier between stages (hopper::grid_sync), with a stage-clock
// reading once the grid has met.
__device__ __forceinline__ void grid_sync(const TowerArgs& a) {
  hopper::grid_sync(a.barrier, [&] { clock_reading(a.clock); });
}

// The launch's dynamic shared memory (every extern __shared__ array names
// its start). The stages compute their addresses from it, and their place
// in the cluster from the special registers, where they run, so that
// neither need be carried from one stage to the next.
extern __shared__ unsigned char dyn_smem[];

__device__ __forceinline__ uint32_t smem_raw() {
  return static_cast<uint32_t>(__cvta_generic_to_shared(dyn_smem));
}
__device__ __forceinline__ uint32_t smem_data() {   // 1024-byte aligned, BAR_BYTES above the start
  return (smem_raw() + BAR_BYTES + 1023u) & ~1023u;
}
__device__ __forceinline__ uint32_t smem_bars() { return smem_data() - BAR_BYTES; }
__device__ __forceinline__ unsigned char* smem_ptr(uint32_t addr) {
  return dyn_smem + (addr - smem_raw());
}
__device__ __forceinline__ hgemm::Smem<BN> gemm_smem() {
  return {smem_data(), smem_ptr(smem_data()), hopper::cluster_rank() ^ 1u, smem_bars()};
}
__device__ __forceinline__ hattn::Smem<NCONS> attn_smem() {
  return {smem_data(), smem_bars() + GEMM_BARS};
}
__device__ __forceinline__ attn_s8::Smem<NCONS> s8_smem() {
  return {attn_smem(), smem_bars() + GEMM_BARS + hattn::Layout<NCONS>::BAR_BYTES,
          smem_ptr(smem_data())};
}

// The state a role carries from one stage to the next: the chunk and layer
// and the ring, staging-tile and attention counters (every role's counts
// agree at a stage's end). Each thread keeps it in local memory (volatile),
// so that the stage bodies have the consumers' registers to themselves.
// ptxas still serialises the tower's wgmma (C7512) when the GEMM and the
// attention consumers share the function, with or without it (PERF.md).
struct Carry {
  int f0, l;
  int loads, staged;         // hgemm::Counts
  int kv, q[NCONS];          // hattn::Counts
};

// A product's parameters and walk, where its roles read them.
template <class Op>
struct Stage {
  typename Op::Params p;
  hgemm::Walk w;
};
static_assert(sizeof(Stage<S8Op>) <= BAR_BYTES - PARAMS_OFF &&
                  sizeof(Stage<BF16Op>) <= BAR_BYTES - PARAMS_OFF,
              "a product's parameters fit their slot");

// One product stage of the role (PRODUCER: the producer warpgroup, else the
// consumers), M x N, K deep. Thread 0 publishes the parameters in shared
// memory, where the roles read them (the per-layer kernel reads them from
// its parameter bank).
template <class Op, int FORM, bool PRODUCER>
__device__ __forceinline__ void gemm_stage(volatile Carry& c, const CUtensorMap* ma,
                                           const CUtensorMap* mb, const typename Op::Params& p,
                                           int m, int n, int k) {
  Stage<Op>* st = reinterpret_cast<Stage<Op>*>(smem_ptr(smem_bars() + PARAMS_OFF));
  if (threadIdx.x == 0) {
    st->p = p;
    st->w = hgemm::make_walk<Op, BN>(m, n, k);
  }
  __syncthreads();
  const hgemm::Smem<BN> sm = gemm_smem();
  const int rank = static_cast<int>(hopper::cluster_rank());
  hgemm::Counts cnt;
  cnt.loads = c.loads;
  cnt.staged = c.staged;
  if constexpr (PRODUCER) {
    if (threadIdx.x == 0) hopper::prefetch_tensormap(mb);
    hgemm::produce_tiles<Op, BN, FORM>(sm, st->w, ma, mb, st->p.out, rank, hopper::cluster_id(),
                                       hopper::cluster_count(), cnt);
  } else {
    hgemm::consume<Op, BN, FORM>(sm, st->w, st->p, threadIdx.x / 128 - 1, rank,
                                 hopper::cluster_id(), hopper::cluster_count(), cnt);
  }
  // every role's counts of the product, whichever role ran it here
  const hgemm::Walk& w = st->w;
  const int units = (w.units - hopper::cluster_id() + hopper::cluster_count() - 1) /
                    hopper::cluster_count();
  c.loads = c.loads + units * w.ktiles;
  if (!(FORM & hgemm::kFormOut32)) c.staged = c.staged + units;
}

// The bf16 attention stage of the role over fc frames: the K/V and Q
// producers on warps 0 and 1, the two consumer warpgroups.
// The attention counters a stage starts from, and the carry after it.
__device__ __forceinline__ hattn::Counts<NCONS> attn_counts(const volatile Carry& c) {
  hattn::Counts<NCONS> cnt;
  cnt.kv = c.kv;
  for (int i = 0; i < NCONS; ++i) cnt.q[i] = c.q[i];
  return cnt;
}
__device__ __forceinline__ void carry_attn(volatile Carry& c, hattn::Counts<NCONS> cnt,
                                           const hattn::Geometry& g) {
  cnt.advance(g);
  c.kv = cnt.kv;
  for (int i = 0; i < NCONS; ++i) c.q[i] = cnt.q[i];
}

template <bool OUT_F32, bool NARROW, bool PRODUCER>
__device__ __forceinline__ void attention_stage(volatile Carry& c, const TowerArgs& a, int fc) {
  const hattn::Geometry g = hattn::geometry<NCONS>(fc, a.tokens, a.heads);
  const hattn::Smem<NCONS> sm = attn_smem();
  const hattn::Counts<NCONS> cnt = attn_counts(c);
  if constexpr (PRODUCER) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0)
      hattn::produce_kv(sm, g, &a.map_k, &a.map_v, cnt);
    else if (warp == 1 && lane == 0)
      hattn::produce_q(sm, g, &a.map_q, cnt);
  } else {
    hattn::consume_as<NCONS, OUT_F32, NARROW>(threadIdx.x / 128 - 1, sm, g, a.coef, a.att, cnt);
  }
  carry_attn(c, cnt, g);
}

// A row stage: fn(row, lane) for rows 0 .. rows - 1, a warp a row over
// every warp of the grid, both roles. (Two rows a warp at once, interleaved,
// ran slower on an H100: PERF.md.)
template <class Fn>
__device__ __forceinline__ void row_stage(int rows, Fn fn) {
  const int lane = threadIdx.x % 32;
  for (int r = blockIdx.x * WARPS + threadIdx.x / 32; r < rows; r += gridDim.x * WARPS)
    fn(r, lane);
}

// A LayerNorm's scale and shift (W each) copied into the shared memory's
// data region, idle during a row stage, by every thread of the block:
// the rows streaming through the little L1 that the stages' shared memory
// leaves would evict them from it. Returns the copy (scale, then shift).
__device__ __forceinline__ const float* stage_norm(const float* scale, const float* shift,
                                                   int width) {
  float* ss = reinterpret_cast<float*>(smem_ptr(smem_data()));
  for (int i = threadIdx.x; i < width; i += THREADS) {
    ss[i] = scale[i];
    ss[width + i] = shift[i];
  }
  __syncthreads();
  return ss;
}

// The int8 attention stage of the role over fc frames' packed qkv rows into
// the f32 att: the per-layer kernel's body (csrc/attention_s8_hopper.cuh),
// its producers and quantisers on the producer warpgroup, the two consumer
// warpgroups; its counters carry on as the bf16 attention stage's do.
template <bool PRODUCER>
__device__ __forceinline__ void s8_attention_stage(volatile Carry& c, const TowerArgs& a, int fc) {
  const hattn::Geometry g = attn_s8::geometry<NCONS>(fc, a.tokens, a.heads);
  const attn_s8::Smem<NCONS> sm = s8_smem();
  const hattn::Counts<NCONS> cnt = attn_counts(c);
  const bool qk = a.attn == 2;
  if constexpr (PRODUCER) {
    if (qk)
      attn_s8::produce<NCONS, true>(sm, g, &a.map_q, &a.map_k, &a.map_v, a.qkv, 3LL * a.width,
                                    cnt);
    else
      attn_s8::produce<NCONS, false>(sm, g, &a.map_q, &a.map_k, &a.map_v, a.qkv, 3LL * a.width,
                                     cnt);
  } else {
    float* out = static_cast<float*>(a.att);
    if (qk)
      attn_s8::consume_as<NCONS, true, true>(threadIdx.x / 128 - 1, sm, g, a.coef_qk, out, cnt);
    else
      attn_s8::consume_as<NCONS, false, true>(threadIdx.x / 128 - 1, sm, g, a.coef_qk, out,
                                              cnt);
  }
  carry_attn(c, cnt, g);
}

// One role's walk over the chunks, layers and stages (the same sequence of
// grid barriers for both). The products' flags and forms are the per-layer
// kernels' (ops/encoder_block.py fused_encoder_block and its last_only
// projection). What a stage needs is derived from the carried chunk and
// layer inside it.
template <bool INT8, bool NARROW, bool PRODUCER>
__device__ __forceinline__ void walk(const TowerArgs& a) {
  using Op = std::conditional_t<INT8, S8Op, BF16Op>;
  using hgemm::kFormExport;
  using hgemm::kFormGelu;
  using hgemm::kFormOut32;
  using hgemm::kFormRes;
  volatile Carry c;
  c.loads = c.staged = c.kv = 0;
  for (int i = 0; i < NCONS; ++i) c.q[i] = 0;
  const hgemm::Export none{nullptr, nullptr, 1, 1, 0, 1, 0};
  for (c.f0 = 0; c.f0 < a.frames; c.f0 = c.f0 + a.chunk) {
    for (c.l = 0; c.l <= a.last; c.l = c.l + 1) {
      // the stage's chunk and layer: fc frames (R rows) from f0, layer l
      auto fc = [&] { return min(a.chunk, a.frames - c.f0); };
      auto lw = [&]() -> const LayerW& { return a.layers[c.l]; };
      auto wm = [&](int i) { return a.wmaps + 4 * c.l + i; };
      auto hin = [&]() -> const bf16* {
        return c.l == 0 ? a.h0 + (size_t)c.f0 * a.tokens * a.width : a.h;
      };
      const int W = a.width, W3 = 3 * W, hid = a.hidden;

      // LN1 (+ the row quantisation), then the qkv projection with the export
      {
        const bf16* x = hin();
        const float* ln = stage_norm(lw().ln[0], lw().ln[1], W);
        if constexpr (INT8)
          row_stage(fc() * a.tokens, [&](int r, int lane) {
            row_ops::layer_norm_quant(x, W, r, ln, ln + W, W, LN_EPS, a.aq, a.as, lane);
          });
        else
          row_stage(fc() * a.tokens, [&](int r, int lane) {
            row_ops::layer_norm(x + (size_t)r * W, ln, ln + W, a.y + (size_t)r * W, W, LN_EPS,
                                lane);
          });
      }
      grid_sync(a);
      const bool last = c.l == a.last;
      {
        const LayerW& p = lw();
        const int R = fc() * a.tokens, col_off = last ? W : 0;   // the last layer: K/V only
        bf16 *kx = nullptr, *vx = nullptr;
        if (c.l >= a.first) {   // slot l - first, frames f0.. of the exports
          const size_t at = ((size_t)(c.l - a.first) * a.frames + c.f0) * a.t_out * W;
          kx = a.k + at;
          vx = a.v + at;
        }
        const hgemm::Export ex{kx, vx, a.tokens, a.t_out, a.lo, W, col_off};
        int flags;
        if constexpr (INT8)
          flags = (last ? 0 : S8Op::kStore) | (kx ? S8Op::kExport : 0);
        else
          flags = BF16Op::kBiasF32 | (last ? 0 : BF16Op::kStore) | (kx ? BF16Op::kExport : 0);
        const hgemm::Out o{a.qkv, nullptr, W3, 0, R, W3 - col_off, flags, false, !last, ex};
        typename Op::Params pp;
        if constexpr (INT8)
          pp = {o, a.as, p.ws[kQkv] + col_off, p.b[kQkv] + col_off};
        else
          pp = {o, p.b[kQkv] + col_off};
        if (kx)
          gemm_stage<Op, kFormExport, PRODUCER>(c, &a.map_in, wm(kQkv), pp, R, W3 - col_off, W);
        else
          gemm_stage<Op, 0, PRODUCER>(c, &a.map_in, wm(kQkv), pp, R, W3 - col_off, W);
      }
      grid_sync(a);
      if (last) break;

      // the attention
      if (!INT8 || a.attn == 0)
        attention_stage<INT8, NARROW, PRODUCER>(c, a, fc());
      else if constexpr (INT8)
        s8_attention_stage<PRODUCER>(c, a, fc());
      grid_sync(a);

      if constexpr (INT8) {
        // the attention output's rows quantised, then the out-projection +
        // h -> f32 hmid
        {
          const int R = fc() * a.tokens;
          row_stage(R, [&](int r, int lane) {
            row_ops::quant_row(static_cast<const float*>(a.att), W, r, W, row_ops::kQuantRows,
                               a.aq, W, a.as, R, R, 0, lane);
          });
        }
        grid_sync(a);
        {
          const LayerW& p = lw();
          gemm_stage<Op, kFormOut32 | kFormRes, PRODUCER>(
              c, &a.map_att, wm(kOut),
              S8Op::Params{hgemm::Out{a.hmid, hin(), W, W, fc() * a.tokens, W,
                                      S8Op::kResBf16 | S8Op::kOutF32 | S8Op::kStore, false,
                                      true, none},
                           a.as, p.ws[kOut], p.b[kOut]},
              fc() * a.tokens, W, W);
        }
        grid_sync(a);
        // LN2 + quantisation, c_fc + QuickGELU -> f32, its rows quantised
        {
          const float* ln = stage_norm(lw().ln[2], lw().ln[3], W);
          row_stage(fc() * a.tokens, [&](int r, int lane) {
            row_ops::layer_norm_quant(a.hmid, W, r, ln, ln + W, W, LN_EPS, a.aq, a.as, lane);
          });
        }
        grid_sync(a);
        {
          const LayerW& p = lw();
          gemm_stage<Op, kFormOut32 | kFormGelu, PRODUCER>(
              c, &a.map_in, wm(kFc),
              S8Op::Params{hgemm::Out{a.mid, nullptr, hid, 0, fc() * a.tokens, hid,
                                      S8Op::kGelu | S8Op::kOutF32 | S8Op::kStore, false, true,
                                      none},
                           a.as, p.ws[kFc], p.b[kFc]},
              fc() * a.tokens, hid, W);
        }
        grid_sync(a);
        {
          const int R = fc() * a.tokens;
          row_stage(R, [&](int r, int lane) {
            row_ops::quant_row(static_cast<const float*>(a.mid), hid, r, hid, row_ops::kQuantRows,
                               a.aq, hid, a.as, R, R, 0, lane);
          });
        }
        grid_sync(a);
        // c_proj + hmid -> bf16 h
        {
          const LayerW& p = lw();
          gemm_stage<Op, kFormRes, PRODUCER>(
              c, &a.map_mid, wm(kProj),
              S8Op::Params{hgemm::Out{a.h, a.hmid, W, W, fc() * a.tokens, W,
                                      S8Op::kResF32 | S8Op::kStore, true, true, none},
                           a.as, p.ws[kProj], p.b[kProj]},
              fc() * a.tokens, W, hid);
        }
      } else {
        // out-projection + h in f32 -> f32 hmid
        {
          const LayerW& p = lw();
          gemm_stage<Op, kFormOut32 | kFormRes, PRODUCER>(
              c, &a.map_att, wm(kOut),
              BF16Op::Params{hgemm::Out{a.hmid, hin(), W, W, fc() * a.tokens, W,
                                        BF16Op::kBiasF32 | BF16Op::kOutF32 |
                                            BF16Op::kResAddF32 | BF16Op::kStore,
                                        false, true, none},
                             p.b[kOut]},
              fc() * a.tokens, W, W);
        }
        grid_sync(a);
        // LN2 of the f32 hmid, c_fc + QuickGELU
        {
          const float* ln = stage_norm(lw().ln[2], lw().ln[3], W);
          row_stage(fc() * a.tokens, [&](int r, int lane) {
            row_ops::layer_norm(a.hmid + (size_t)r * W, ln, ln + W, a.y + (size_t)r * W, W,
                                LN_EPS, lane);
          });
        }
        grid_sync(a);
        {
          const LayerW& p = lw();
          gemm_stage<Op, kFormGelu, PRODUCER>(
              c, &a.map_in, wm(kFc),
              BF16Op::Params{hgemm::Out{a.mid, nullptr, hid, 0, fc() * a.tokens, hid,
                                        BF16Op::kBiasF32 | BF16Op::kGelu | BF16Op::kStore,
                                        false, true, none},
                             p.b[kFc]},
              fc() * a.tokens, hid, W);
        }
        grid_sync(a);
        // c_proj + hmid in f32 -> bf16 h
        {
          const LayerW& p = lw();
          gemm_stage<Op, kFormRes, PRODUCER>(
              c, &a.map_mid, wm(kProj),
              BF16Op::Params{hgemm::Out{a.h, a.hmid, W, W, fc() * a.tokens, W,
                                        BF16Op::kBiasF32 | BF16Op::kResAddF32 |
                                            BF16Op::kResIsF32 | BF16Op::kStore,
                                        true, true, none},
                             p.b[kProj]},
              fc() * a.tokens, W, hid);
        }
      }
      grid_sync(a);
    }
  }
}

template <bool INT8, bool NARROW>
__global__ void __launch_bounds__(THREADS, 1)
encoder_tower_kernel(const __grid_constant__ TowerArgs a) {
  if (threadIdx.x == 0) {
    gemm_smem().init();
    attn_smem().init(hattn::geometry<NCONS>(1, a.tokens, a.heads));
    s8_smem().init_ready();
  }
  hopper::cluster_sync();   // the peer's barriers exist before it is written to
  clock_reading(a.clock);
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: the TMA threads and the store warps ----------------
    hopper::setmaxnreg_dec<hgemm::PRODUCER_REGS>();
    walk<INT8, NARROW, true>(a);
  } else {
    // ---- the consumer warpgroups: the products, the attention, the row stages ----
    hopper::setmaxnreg_inc<hgemm::CONSUMER_REGS>();
    walk<INT8, NARROW, false>(a);
  }
}

using TowerKernel = void (*)(TowerArgs);

// The four kernels, each in a translation unit of its own
// (encoder_tower_{bf16,s8}{,_narrow}.cu) so that the build compiles them in
// parallel.
TowerKernel kernel_bf16();
TowerKernel kernel_bf16_narrow();
TowerKernel kernel_s8();
TowerKernel kernel_s8_narrow();

inline TowerKernel tower_kernel(int tokens, int int8) {
  if (hattn::narrow(tokens)) return int8 ? kernel_s8_narrow() : kernel_bf16_narrow();
  return int8 ? kernel_s8() : kernel_bf16();
}

inline size_t tower_smem(int int8, int attn) {
  size_t data = GEMM_DATA > ATTN_DATA ? GEMM_DATA : ATTN_DATA;
  if (int8 && attn != 0 && S8_DATA > data) data = S8_DATA;
  return SLACK + data;
}

inline cudaLaunchConfig_t launch_config(int int8, int attn, int grid, void* stream,
                                        cudaLaunchAttribute (&attr)[2]) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = tower_smem(int8, attn);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace tower
