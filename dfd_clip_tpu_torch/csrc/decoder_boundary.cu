// The decoder's block boundary in one cooperative launch: the tail of the
// block being closed (out-projection + residual, LN2, c_fc + QuickGELU,
// c_proj + residual) and the query of the next block (LN1', in-projection),
// on B rows of width W.
//
// Replaces: dfd_clip_tpu/ops/pallas_decoder_stack.py:decoder_boundary
// (_boundary_kernel), which runs the boundary as one call; its numerics are
// models/layers.py's: LayerNorm in f32 cast back, each product rounded to
// bf16 before the bias is added in bf16, QuickGELU in f32, residuals added
// to the rounded values.
//
// Bound on an H100: the weights' bytes. A boundary reads 2 x 11 W^2 bytes of
// bf16 weights (13 MB at W = 768, 23 MB at W = 1024) against 2 x 16 x 11 W^2
// FLOP at the serve batch's 16 rows: 0.0039 / 0.0070 ms at 3.35 TB/s. The
// six launches it replaces took about 0.25 ms of host time, the card idle
// between them.
//
// Design: one block a SM (a cooperative launch, so every block is resident
// and a grid barrier can separate the stages), 8 warps.
// - Weights early. The weights do not depend on the activations, so one
//   thread of each block issues the loads of all of the block's column
//   slices of the four products into shared memory: the first stage's at
//   launch, the others as soon as that stage is done (issued all at launch,
//   the 23 MB stream at W = 1024 held the out-projection's own reads back by
//   5 us). Each stage's columns are dealt in units of 8 across the grid,
//   block c taking units [c U / G, (c + 1) U / G), and each weight is held
//   transposed, (N, K) (prepared once with the parameters' plan,
//   ops/_cuda.py), so a block's slice of a stage is one contiguous run of
//   16 K bytes a unit: one bulk copy (cp.async.bulk) a stage, completing on
//   that stage's mbarrier. The weight stream then runs under the stages and
//   barriers instead of after them, at whole-line efficiency. (Slices of the
//   (K, N) weights are K rows of 16 bytes: moved by TMA boxes of 8 columns,
//   or by cp.async from every thread, a middle boundary at W = 768 took
//   36 us on the card, bound by the requests a SM keeps in flight.)
// - Stages: out-proj, then c_fc, then c_proj, then in-proj, a grid barrier
//   (hopper::grid_sync, without the async-proxy fence: the stages read what
//   the grid wrote with generic loads, and the fence would wait for the
//   weight slices in flight) after each stage whose output the next reads
//   whole: three in the middle form, two in the last (tail only), none in
//   the first (query only). Each block computes LN2 / LN1' of the rows
//   itself (the tower's row arithmetic, row_ops::ln_values, into a padded
//   bf16 tile in shared memory, two rows a warp loaded together, scale and
//   shift copied into shared memory at launch ahead of the weights), which
//   costs less than another barrier.
// - Products: mma.sync m16n8k16 (bf16 in, f32 accumulate), 16 rows a tile
//   (the serve batch is one tile; the rows past B are masked), K split over
//   the warps. A lane reads 8 neighbouring K values of an A row (from the
//   LayerNorm tile, or from global memory for the attention output and the
//   MLP intermediate) and the same 8 of its weight column (a row of the
//   transposed slice) as one 16-byte load each, and feeds them to two k16
//   products, so both operands hold the same permutation of K. The warps'
//   partial sums meet in shared memory and are summed in the order of their
//   K-chunks, so the result does not depend on timing.
// - Epilogues: gemm's own, BF16Op::apply (csrc/gemm_ops.cuh) with the bias
//   added after the bf16 cast and QuickGELU on c_fc, and the bf16 residual
//   added to the rounded value as gemm's store warps add it. The chain of
//   six launches that this kernel replaces (gemm and layer_norm_rows) thus
//   differs from it only in the f32 order of a product's sums.
//
// The streamed form (widths whose resident slices do not fit: 1536, DINOv2
// ViT-g/14's decoder, whose slices would take 541,952 bytes a block). At
// W = 1536 a boundary's 25.95 M weights (51.9 MB bf16) exceed the 50 MB L2,
// so every call streams them from HBM: 15.5 us at 3.35 TB/s, the bound.
// - The same deal of units, products, LayerNorm tile and epilogues; what
//   changes is where the weights wait. A block's slice of a stage is cut
//   into chunks of KC K values (512 at W = 1536), and the chunks of every
//   stage of the form, in the order the stages run them (tile by tile),
//   flow through a ring of 2 to 4 slots in shared memory: warp 0 issues a
//   chunk's rows (one bulk copy of 2 KC bytes a weight row, 8 rows a unit,
//   the rows dealt over its lanes) into the next free slot, completing on
//   the slot's mbarrier, and refills a slot as soon as every warp is past
//   it (a __syncthreads a chunk). The ring does not wait for the stages:
//   the next stage's first chunks are in flight across each grid barrier.
//   (On an H100 a ring of 2 slots reads as fast as 3, and chunks of 256
//   values take 1.5x the time of 512: the cost is a chunk's, not a
//   byte's.)
// - A slot's rows are 2 KC + 64 bytes apart, so the 16-byte loads of a
//   quarter-warp (two rows, four lanes each) fall on distinct banks.
// - Each warp takes KC / 256 K-steps of every chunk and keeps its sums
//   across the chunks; the partial sums meet in warp order. The A operand
//   (the LayerNorm tile, or the attention output or MLP intermediate from
//   L2) of the next chunk is loaded before the warp waits for this chunk's
//   weights. (Two A buffers taking turns, instead of the copy at the end of
//   a chunk, read slower: 0.0676 ms against 0.0603, with spills.)
// - The block's chunk sequence is worked out once a launch (ChunkSeq):
//   recomputing each stage's slice at every refill (64-bit divisions on
//   warp 0, which every warp then waits for at the next chunk's barrier)
//   cost a middle call 0.0807 ms against 0.0603 (H100 80GB HBM3, 700 W).
// - The LayerNorm tile is made a row at a time with up to 6 256-wide
//   chunks a row in registers (W <= 1536).
#include <string.h>

#include "gemm_ops.cuh"
#include "rows.cuh"

namespace {

using hgemm::BF16Op;
using namespace hopper;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16;        // rows of a tile: the product's M
constexpr int UNIT = 8;         // columns of a unit: the product's N
constexpr int KSTEP = 32;       // K of a lane's 16-byte A load: two k16 products
constexpr int BATCH = 8;        // K-steps whose A loads go out together
constexpr int MAX_UNITS = 6;    // units a block may take in one stage (4 on 132 SMs)
constexpr int A_PAD = 32;       // bf16 values past a LayerNorm row in its tile (64 bytes)
constexpr float EPS = 1e-5f;
// the streamed form: the most ring slots (their mbarriers come first, the
// LayerNorms' after them, as the resident form's), the most K-steps a warp
// takes of a chunk (KC <= 512), and the 256-wide chunks of its LayerNorm row
constexpr int MAX_SLOTS = 4;
constexpr int MAX_CHUNK_KSTEPS = 2;
constexpr int STREAM_LN_CHUNKS = 6;

enum : int { kOut = 0, kFc = 1, kProj = 2, kIn = 3, kStages = 4 };

// The stage clock (tools/bench_decoder_boundary.py reads it): each block's
// thread 0 writes %globaltimer (ns) at the launch's start, once its weight
// loads are issued, as each stage's slices arrive (ARRIVED + stage), as
// each stage ends (ENDED + stage), as each grid barrier completes (MET +
// 0..2), as ln_2's and ln_1's parameters arrive (LN_IN + 0, 1) and their
// tile is normalised (LN_DONE + 0, 1), and as each stage's products are
// done (PRODUCT + stage); a reading the form does not reach stays 0.
enum : int {
  START = 0, ISSUED = 1, ARRIVED = 2, ENDED = 6, MET = 10, LN_IN = 13, LN_DONE = 15,
  PRODUCT = 17, CLOCKS = 21
};

// What a call's parameters give, prepared once (dfd_decoder_boundary_plan).
struct Plan {
  const bf16* w[kStages];      // the weights transposed, (N, K) bf16, contiguous
  const float* bias[kStages];
  const float* ln[4];          // ln_2 scale, shift; ln_1 scale, shift
  int width, hidden;
  int w_off[kStages];          // the stages' weight slices, bytes above the aligned base
                               // (whose first 48 bytes hold the mbarriers)
  int ln_off;                  // the LayerNorms' scale and shift (ln_2, then ln_1; W f32 each)
  int a_off;                   // the LayerNorm tile / the warps' partial sums
  int smem;                    // the launch's dynamic shared memory
  int grid;
  // the streamed form (kc > 0): K values a chunk, ring slots, bytes between
  // a slot's weight rows and between slots, and the ring's offset
  int kc, slots, pitch, slot_bytes, ring_off;
};

struct Args {
  Plan p;
  const bf16* x;      // (B, W): the residual stream
  const bf16* o;      // (B, W): the attention output (tail)
  bf16* x_out;        // (B, W) (tail)
  bf16* qrow;         // (B, 2W) (query)
  bf16* x1;           // (B, W) scratch: x after the out-projection
  bf16* mid;          // (B, hidden) scratch: the MLP intermediate
  unsigned* barrier;  // the grid barrier's counter (low 31 bits 0)
  unsigned long long* clock;   // or null: CLOCKS %globaltimer readings a block (see above)
  int rows;
  int tail, query;
};

__device__ __forceinline__ void clock_reading(const Args& a, int at) {
  if (a.clock == nullptr || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  a.clock[blockIdx.x * CLOCKS + at] = t;
}

__device__ __forceinline__ int stage_k(const Plan& p, int s) {
  return s == kProj ? p.hidden : p.width;
}
__device__ __forceinline__ int stage_n(const Plan& p, int s) {
  return s == kFc ? p.hidden : s == kIn ? 2 * p.width : p.width;
}

// This block's units [u0, u0 + cnt) of a stage of `units` units.
struct Slice {
  int u0, cnt;
};
__device__ __forceinline__ Slice slice(int units) {
  const int c = blockIdx.x, g = gridDim.x;
  const int u0 = static_cast<int>((long long)c * units / g);
  return {u0, static_cast<int>((long long)(c + 1) * units / g) - u0};
}

__device__ __forceinline__ uint4 lds16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// `bytes` (a multiple of 16) from global memory into shared memory at dst,
// completing a transaction on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[q] += the tile's A rows x unit q's weight slice (8 rows of K values,
// transposed: column n of the unit at w + (q * 8 + n) * K * 2) over this
// warp's K-steps [ks0, ks1). A: the LayerNorm tile in shared memory
// (SMEM_A; a_smem, row pitch lda values) or `live` rows of global memory
// (ag, row pitch lda; the rest read as 0). A lane holds A values 8t..8t+7
// of a K-step (t = lane % 4) of rows g and g + 8 (g = lane / 4), and the
// weight's values 8t..8t+7 of column g, each one 16-byte load: the first
// k16 product takes 8t..8t+3 of both, the second 8t+4..8t+7, so both
// operands name the same K in every slot.
template <bool SMEM_A>
__device__ __forceinline__ void product(float (&acc)[MAX_UNITS][4], uint32_t a_smem,
                                        const bf16* ag, int lda, int live, uint32_t w, int K,
                                        int cnt, int ks0, int ks1, int lane) {
  const int g = lane / 4, t = lane % 4;
  const uint32_t wcol = w + (g * K + 8 * t) * 2;   // this lane's column and K offset
  for (int kb = ks0; kb < ks1; kb += BATCH) {
    uint4 lo[BATCH], hi[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int k = (kb + j) * KSTEP + 8 * t;
      lo[j] = hi[j] = make_uint4(0, 0, 0, 0);
      if (kb + j < ks1) {
        if constexpr (SMEM_A) {
          lo[j] = lds16(a_smem + (g * lda + k) * 2);
          hi[j] = lds16(a_smem + ((g + 8) * lda + k) * 2);
        } else {
          if (g < live) lo[j] = __ldcg(reinterpret_cast<const uint4*>(ag + (size_t)g * lda + k));
          if (g + 8 < live)
            hi[j] = __ldcg(reinterpret_cast<const uint4*>(ag + (size_t)(g + 8) * lda + k));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (kb + j >= ks1) break;
      const uint32_t wk = wcol + (kb + j) * KSTEP * 2;
#pragma unroll
      for (int q = 0; q < MAX_UNITS; ++q) {
        if (q < cnt) {
          const uint4 b = lds16(wk + q * UNIT * K * 2);
          mma16816(acc[q], lo[j].x, hi[j].x, lo[j].y, hi[j].y, b.x, b.y);
          mma16816(acc[q], lo[j].z, hi[j].z, lo[j].w, hi[j].w, b.z, b.w);
        }
      }
    }
  }
}

// LN of the live rows of src from r0 into the tile (row pitch lda), two rows
// a warp with both rows' loads issued before either's reductions; the
// lane's slices of scale and shift read from shared memory once, as 16-byte
// vectors, into registers (read at each use, a lane's 8 values 32 bytes
// from the next lane's, they took bank conflicts: 5 us a tile on the card,
// against 2.8 - 4.4). row_ops::ln_values's arithmetic, as layer_norm_rows's
// and the tower's.
__device__ __forceinline__ void ln_tile(const bf16* src, int lds, int r0, int live,
                                        const float* scale, const float* shift, bf16* tile,
                                        int lda, int width, int warp, int lane) {
  constexpr int PER = TILE / WARPS;
  float v[PER][row_ops::LN_CHUNKS][8];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int r = warp + j * WARPS;
#pragma unroll
    for (int i = 0; i < row_ops::LN_CHUNKS; ++i) {
      const int c = lane * 8 + i * 256;
      if (r < live && c < width) load8(src + (size_t)(r0 + r) * lds + c, v[j][i]);
    }
  }
  row_ops::AffineRegs<row_ops::LN_CHUNKS> aff;
  aff.load(scale, shift, width, lane);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int r = warp + j * WARPS;
    if (r < live) {
      row_ops::ln_values(v[j], aff, width, EPS, lane);
      row_ops::store_ln_row(v[j], tile + r * lda, width, lane);
    }
  }
}

// The streamed form's ln_tile: rows of up to STREAM_LN_CHUNKS x 256 values,
// one row a warp at a time (the same arithmetic).
__device__ __forceinline__ void ln_tile_wide(const bf16* src, int lds, int r0, int live,
                                             const float* scale, const float* shift, bf16* tile,
                                             int lda, int width, int warp, int lane) {
  row_ops::AffineRegs<STREAM_LN_CHUNKS> aff;
  aff.load(scale, shift, width, lane);
#pragma unroll 1
  for (int r = warp; r < live; r += WARPS) {
    float v[STREAM_LN_CHUNKS][8];
#pragma unroll
    for (int i = 0; i < STREAM_LN_CHUNKS; ++i) {
      const int c = lane * 8 + i * 256;
      if (c < width) load8(src + (size_t)(r0 + r) * lds + c, v[i]);
    }
    row_ops::ln_values(v, aff, width, EPS, lane);
    row_ops::store_ln_row(v, tile + r * lda, width, lane);
  }
}

// The end of a tile of a stage: each warp's sums (acc, over its K-chunk
// `chunk`) into shared memory above the tile, added in chunk order, then
// gemm's epilogue (bias after the bf16 cast, QuickGELU with GELU) and, with
// res, the bf16 residual added to the rounded value; out has row pitch ldo.
// Every warp must be past the tile before the sums overwrite it.
template <int S, bool GELU>
__device__ __forceinline__ void finish_tile(const Args& a, unsigned char* gbase, Slice sl,
                                            int r0, int chunk,
                                            const float (&acc)[MAX_UNITS][4], const bf16* res,
                                            bf16* out, int ldo) {
  const Plan& p = a.p;
  const int lane = threadIdx.x % 32;
  float4* part = reinterpret_cast<float4*>(gbase + p.a_off);
  BF16Op::Params prm{};
  prm.out.flags = BF16Op::kBiasBf16;
  prm.bias = p.bias[S];
#pragma unroll
  for (int q = 0; q < MAX_UNITS; ++q)
    if (q < sl.cnt)
      part[(chunk * sl.cnt + q) * 32 + lane] = make_float4(acc[q][0], acc[q][1], acc[q][2],
                                                           acc[q][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < sl.cnt * 32; i += THREADS) {
    const int q = i / 32, l = i % 32;
    float4 sum = part[q * 32 + l];
    for (int ch = 1; ch < WARPS; ++ch) {
      const float4 pv = part[(ch * sl.cnt + q) * 32 + l];
      sum.x += pv.x;
      sum.y += pv.y;
      sum.z += pv.z;
      sum.w += pv.w;
    }
    // values: rows g, g + 8 of the tile, columns col, col + 1 of each
    const int g = l / 4, col = (sl.u0 + q) * UNIT + 2 * (l % 4);
    const float b0 = p.bias[S][col], b1 = p.bias[S][col + 1];
    const float x4[4] = {sum.x, sum.y, sum.z, sum.w}, b4[4] = {b0, b1, b0, b1};
    const float z4[4] = {0.f, 0.f, 0.f, 0.f};
    float v[4];
    BF16Op::apply<GELU ? hgemm::kFormGelu : 0, 4>(prm, x4, b4, z4, z4, z4, v);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row >= a.rows) continue;
      __nv_bfloat162 y = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
      if (res != nullptr) {
        const unsigned rv =
            __ldcg(reinterpret_cast<const unsigned*>(res + (size_t)row * p.width + col));
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&rv);
        y = __floats2bfloat162_rn(__bfloat162float(r.x) + __bfloat162float(y.x),
                                  __bfloat162float(r.y) + __bfloat162float(y.y));
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ldo + col) = y;
    }
  }
  __syncthreads();   // the partial sums are read before the next tile's A
}

// One product stage on every tile of rows: A (LN of src's rows into the
// tile, or src's rows read in place), this block's units of the weight, the
// warps' partial sums added in K-chunk order, then gemm's epilogue (bias after
// the bf16 cast, QuickGELU with GELU) and, with res, the bf16 residual added
// to the rounded value. src, res and out have row pitches lds, W and ldo.
template <int S, bool LN, bool GELU>
__device__ __forceinline__ void stage(const Args& a, uint32_t base, unsigned char* gbase,
                                      const bf16* src, int lds, const bf16* res, bf16* out,
                                      int ldo) {
  const Plan& p = a.p;
  const int K = stage_k(p, S);
  const Slice sl = slice(stage_n(p, S) / UNIT);
  if (sl.cnt == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's chunk of K: rotated by the block, so that the blocks reading
  // one A from L2 at once (the attention output, the MLP intermediate) start
  // on different lines; the partial sums are added in chunk order
  const int chunk = (warp + blockIdx.x) % WARPS;
  const int nks = K / KSTEP, ks0 = chunk * nks / WARPS, ks1 = (chunk + 1) * nks / WARPS;
  const int lda = p.width + A_PAD;
  bf16* tile = reinterpret_cast<bf16*>(gbase + p.a_off);
  for (int r0 = 0; r0 < a.rows; r0 += TILE) {
    const int live = min(TILE, a.rows - r0);
    if constexpr (LN) {
      const int l = S == kFc ? 0 : 1;   // ln_2, or ln_1
      const float* ln = reinterpret_cast<const float*>(gbase + p.ln_off) + 2 * l * p.width;
      mbar_wait(base + 8 * (kStages + l), 0);   // the LayerNorm's parameters
      if (r0 == 0) clock_reading(a, LN_IN + l);
      ln_tile(src, lds, r0, live, ln, ln + p.width, tile, lda, p.width, warp, lane);
      __syncthreads();
      if (r0 == 0) clock_reading(a, LN_DONE + l);
    }
    mbar_wait(base + 8 * S, 0);   // the stage's weight slices are in
    if (r0 == 0) clock_reading(a, ARRIVED + S);
    float acc[MAX_UNITS][4] = {};
    product<LN>(acc, base + p.a_off, src + (size_t)r0 * lds, LN ? lda : lds, live,
                base + p.w_off[S], K, sl.cnt, ks0, ks1, lane);
    __syncthreads();   // every warp is past the tile before the partial sums overwrite it
    if (r0 == 0) clock_reading(a, PRODUCT + S);
    finish_tile<S, GELU>(a, gbase, sl, r0, chunk, acc, res, out, ldo);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_boundary_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char dyn_smem[];
  const Plan& p = a.p;
  clock_reading(a, START);
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(dyn_smem));
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* gbase = dyn_smem + (base - raw);
  // this block's weight slices of stage s, where the form has the stage and
  // the deal gives the block units of it (thread 0)
  auto issue = [&](int s) {
    if (!(s == kIn ? a.query : a.tail)) return;
    const int K = stage_k(p, s);
    const Slice sl = slice(stage_n(p, s) / UNIT);
    if (sl.cnt == 0) return;
    const uint32_t bytes = sl.cnt * UNIT * K * 2;
    mbar_expect_tx(base + 8 * s, bytes);
    bulk_load(base + p.w_off[s], p.w[s] + (size_t)sl.u0 * UNIT * K, bytes, base + 8 * s);
  };
  if (threadIdx.x == 0) {
    // barriers: the four stages' weight slices, then ln_2's and ln_1's parameters
    for (int s = 0; s < kStages + 2; ++s) mbar_init(base + 8 * s, 1);
    mbar_fence_init();
    // the LayerNorms' parameters first (a stage's LayerNorm waits for them,
    // not for its weights), then the first stage's slices; the others go
    // out once that stage is done, so that its own reads of the attention
    // output from L2 do not queue behind the whole weight stream
    const uint32_t ln_bytes = 4u * p.width;
    for (int l = 0; l < 2; ++l) {
      const int s = l == 0 ? kFc : kIn;
      if (!(l == 0 ? a.tail : a.query) || slice(stage_n(p, s) / UNIT).cnt == 0) continue;
      const uint32_t bar = base + 8 * (kStages + l);
      mbar_expect_tx(bar, 2 * ln_bytes);
      for (int h = 0; h < 2; ++h)
        bulk_load(base + p.ln_off + (2 * l + h) * ln_bytes, p.ln[2 * l + h], ln_bytes, bar);
    }
    issue(a.tail ? kOut : kIn);
  }
  __syncthreads();   // the barriers exist before any thread waits on them
  clock_reading(a, ISSUED);
  const int W = p.width;
  auto none = [] {};
  if (a.tail) {
    stage<kOut, false, false>(a, base, gbase, a.o, W, a.x, a.x1, W);
    if (threadIdx.x == 0) {
      issue(kFc);
      issue(kProj);
      issue(kIn);
    }
    clock_reading(a, ENDED + kOut);
    grid_sync<false>(a.barrier, none);
    clock_reading(a, MET);
    stage<kFc, true, true>(a, base, gbase, a.x1, W, nullptr, a.mid, p.hidden);
    clock_reading(a, ENDED + kFc);
    grid_sync<false>(a.barrier, none);
    clock_reading(a, MET + 1);
    stage<kProj, false, false>(a, base, gbase, a.mid, p.hidden, a.x1, a.x_out, W);
    clock_reading(a, ENDED + kProj);
    if (a.query) {
      grid_sync<false>(a.barrier, none);
      clock_reading(a, MET + 2);
    }
  }
  if (a.query) {
    stage<kIn, true, false>(a, base, gbase, a.tail ? a.x_out : a.x, W, nullptr, a.qrow, 2 * W);
    clock_reading(a, ENDED + kIn);
  }
}

// ---- the streamed form ----------------------------------------------------------
// The block's chunk sequence (stage by stage in the form's order, tile by
// tile, K-chunk by K-chunk), worked out once a launch by thread 0 into
// shared memory above the mbarriers (SEQ_OFF), where warp 0 reads it at
// each refill: stage s's chunks are [first[s], first[s + 1]), none where
// the form lacks the stage or the deal gives the block no units of it.
constexpr int SEQ_OFF = 64;
struct ChunkSeq {
  int first[kStages + 1];
  Slice sl[kStages];
};
static_assert(SEQ_OFF >= 8 * (MAX_SLOTS + 2) && SEQ_OFF + sizeof(ChunkSeq) <= 128,
              "the sequence lies between the mbarriers and the ring (BOUNDARY_BARS = 128)");

__device__ __forceinline__ void chunk_seq(const Args& a, ChunkSeq* q) {
  q->first[0] = 0;
  for (int s = 0; s < kStages; ++s) {
    q->sl[s] = slice(stage_n(a.p, s) / UNIT);
    const bool has = (s == kIn ? a.query : a.tail) && q->sl[s].cnt > 0;
    q->first[s + 1] =
        q->first[s] + (has ? (a.rows + TILE - 1) / TILE * (stage_k(a.p, s) / a.p.kc) : 0);
  }
}

// Chunk `seq` of the sequence into ring slot seq % slots, completing on
// that slot's mbarrier: a bulk copy of KC values from each weight row of
// the block's units, the rows dealt over warp 0's lanes (lane 0 posts the
// bytes first); past the sequence's end, nothing. Warp 0, every lane.
__device__ __forceinline__ void issue_chunk(const Args& a, uint32_t base, const ChunkSeq& q,
                                            int seq, int lane) {
  const Plan& p = a.p;
  if (seq >= q.first[kStages]) return;
  int s = 0;
  while (seq >= q.first[s + 1]) ++s;
  const int K = stage_k(p, s), c = (seq - q.first[s]) % (K / p.kc);
  const Slice sl = q.sl[s];
  const uint32_t bar = base + 8 * (seq % p.slots);
  const uint32_t dst = base + p.ring_off + (seq % p.slots) * p.slot_bytes;
  const bf16* src = p.w[s] + (size_t)sl.u0 * UNIT * K + (size_t)c * p.kc;
  const int rows = sl.cnt * UNIT;
  if (lane == 0) mbar_expect_tx(bar, rows * p.kc * 2);
  __syncwarp();
  for (int n = lane; n < rows; n += 32)
    bulk_load(dst + n * p.pitch, src + (size_t)n * K, p.kc * 2, bar);
}

// One product stage of the streamed form on every tile of rows: as stage(),
// with the weights taken chunk by chunk from the ring; `seq` is the block's
// place in its chunk sequence, advanced past the stage's chunks.
template <int S, bool LN, bool GELU>
__device__ __forceinline__ void stream_stage(const Args& a, uint32_t base, unsigned char* gbase,
                                             const bf16* src, int lds, const bf16* res,
                                             bf16* out, int ldo, int& seq) {
  const Plan& p = a.p;
  const int K = stage_k(p, S);
  const Slice sl = slice(stage_n(p, S) / UNIT);
  if (sl.cnt == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nks = p.kc / (KSTEP * WARPS);   // this warp's K-steps of a chunk
  const int lda = p.width + A_PAD;
  bf16* tile = reinterpret_cast<bf16*>(gbase + p.a_off);
  const uint32_t a_smem = base + p.a_off;
  const ChunkSeq& chunks = *reinterpret_cast<const ChunkSeq*>(gbase + SEQ_OFF);
  for (int r0 = 0; r0 < a.rows; r0 += TILE) {
    const int live = min(TILE, a.rows - r0);
    const bf16* ag = src + (size_t)r0 * lds;
    if constexpr (LN) {
      const int l = S == kFc ? 0 : 1;   // ln_2, or ln_1
      const float* ln = reinterpret_cast<const float*>(gbase + p.ln_off) + 2 * l * p.width;
      mbar_wait(base + 8 * (MAX_SLOTS + l), 0);   // the LayerNorm's parameters
      if (r0 == 0) clock_reading(a, LN_IN + l);
      ln_tile_wide(src, lds, r0, live, ln, ln + p.width, tile, lda, p.width, warp, lane);
      __syncthreads();
      if (r0 == 0) clock_reading(a, LN_DONE + l);
    }
    const int kw = warp * nks * KSTEP;   // the warp's first K value within a chunk
    // this warp's A values of chunk c: rows g and g + 8, KC / 256 K-steps
    auto load_a = [&](int c, uint4 (&lo)[MAX_CHUNK_KSTEPS], uint4 (&hi)[MAX_CHUNK_KSTEPS]) {
#pragma unroll
      for (int j = 0; j < MAX_CHUNK_KSTEPS; ++j) {
        const int k = c * p.kc + kw + j * KSTEP + 8 * t;
        lo[j] = hi[j] = make_uint4(0, 0, 0, 0);
        if (j < nks) {
          if constexpr (LN) {
            lo[j] = lds16(a_smem + (g * lda + k) * 2);
            hi[j] = lds16(a_smem + ((g + 8) * lda + k) * 2);
          } else {
            if (g < live) lo[j] = __ldcg(reinterpret_cast<const uint4*>(ag + (size_t)g * lds + k));
            if (g + 8 < live)
              hi[j] = __ldcg(reinterpret_cast<const uint4*>(ag + (size_t)(g + 8) * lds + k));
          }
        }
      }
    };
    float acc[MAX_UNITS][4] = {};
    uint4 lo[MAX_CHUNK_KSTEPS], hi[MAX_CHUNK_KSTEPS];
    load_a(0, lo, hi);
    for (int c = 0; c < K / p.kc; ++c, ++seq) {
      // the next chunk's A goes out before this chunk's weights are waited for
      uint4 nlo[MAX_CHUNK_KSTEPS] = {}, nhi[MAX_CHUNK_KSTEPS] = {};
      if (c + 1 < K / p.kc) load_a(c + 1, nlo, nhi);
      const int slot = seq % p.slots;
      mbar_wait(base + 8 * slot, (seq / p.slots) & 1);
      if (r0 == 0 && c == 0) clock_reading(a, ARRIVED + S);
      const uint32_t wrow =
          base + p.ring_off + slot * p.slot_bytes + g * p.pitch + (kw + 8 * t) * 2;
#pragma unroll
      for (int j = 0; j < MAX_CHUNK_KSTEPS; ++j) {
        if (j >= nks) break;
#pragma unroll
        for (int q = 0; q < MAX_UNITS; ++q) {
          if (q < sl.cnt) {
            const uint4 b = lds16(wrow + j * KSTEP * 2 + q * UNIT * p.pitch);
            mma16816(acc[q], lo[j].x, hi[j].x, lo[j].y, hi[j].y, b.x, b.y);
            mma16816(acc[q], lo[j].z, hi[j].z, lo[j].w, hi[j].w, b.z, b.w);
          }
        }
      }
      __syncthreads();   // every warp is past the slot (and, at the last chunk, the tile)
      if (warp == 0) issue_chunk(a, base, chunks, seq + p.slots, lane);
#pragma unroll
      for (int j = 0; j < MAX_CHUNK_KSTEPS; ++j) {
        lo[j] = nlo[j];
        hi[j] = nhi[j];
      }
    }
    if (r0 == 0) clock_reading(a, PRODUCT + S);
    finish_tile<S, GELU>(a, gbase, sl, r0, warp, acc, res, out, ldo);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
decoder_boundary_streamed_kernel(const __grid_constant__ Args a) {
  extern __shared__ unsigned char dyn_smem[];
  const Plan& p = a.p;
  clock_reading(a, START);
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(dyn_smem));
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* gbase = dyn_smem + (base - raw);
  const ChunkSeq& chunks = *reinterpret_cast<const ChunkSeq*>(gbase + SEQ_OFF);
  if (threadIdx.x == 0) {
    chunk_seq(a, reinterpret_cast<ChunkSeq*>(gbase + SEQ_OFF));
    // barriers: the ring's slots, then ln_2's and ln_1's parameters
    for (int i = 0; i < p.slots; ++i) mbar_init(base + 8 * i, 1);
    for (int l = 0; l < 2; ++l) mbar_init(base + 8 * (MAX_SLOTS + l), 1);
    mbar_fence_init();
    const uint32_t ln_bytes = 4u * p.width;
    for (int l = 0; l < 2; ++l) {
      const int s = l == 0 ? kFc : kIn;
      if (!(l == 0 ? a.tail : a.query) || slice(stage_n(p, s) / UNIT).cnt == 0) continue;
      const uint32_t bar = base + 8 * (MAX_SLOTS + l);
      mbar_expect_tx(bar, 2 * ln_bytes);
      for (int h = 0; h < 2; ++h)
        bulk_load(base + p.ln_off + (2 * l + h) * ln_bytes, p.ln[2 * l + h], ln_bytes, bar);
    }
  }
  if (threadIdx.x < 32) {
    __syncwarp();   // the barriers and the sequence exist before the lanes read them
    for (int i = 0; i < p.slots; ++i) issue_chunk(a, base, chunks, i, threadIdx.x);
  }
  __syncthreads();   // the barriers exist before any thread waits on them
  clock_reading(a, ISSUED);
  const int W = p.width;
  int seq = 0;
  auto none = [] {};
  if (a.tail) {
    stream_stage<kOut, false, false>(a, base, gbase, a.o, W, a.x, a.x1, W, seq);
    clock_reading(a, ENDED + kOut);
    grid_sync<false>(a.barrier, none);
    clock_reading(a, MET);
    stream_stage<kFc, true, true>(a, base, gbase, a.x1, W, nullptr, a.mid, p.hidden, seq);
    clock_reading(a, ENDED + kFc);
    grid_sync<false>(a.barrier, none);
    clock_reading(a, MET + 1);
    stream_stage<kProj, false, false>(a, base, gbase, a.mid, p.hidden, a.x1, a.x_out, W, seq);
    clock_reading(a, ENDED + kProj);
    if (a.query) {
      grid_sync<false>(a.barrier, none);
      clock_reading(a, MET + 2);
    }
  }
  if (a.query) {
    stream_stage<kIn, true, false>(a, base, gbase, a.tail ? a.x_out : a.x, W, nullptr, a.qrow,
                                   2 * W, seq);
    clock_reading(a, ENDED + kIn);
  }
}

int smem_attribute = 0;   // the dynamic shared memory the resident kernel is set up for
int stream_smem_attribute = 0;   // and the streamed one

}  // namespace

extern "C" int dfd_decoder_boundary_plan_bytes() { return static_cast<int>(sizeof(Plan)); }

// Prepare the plan of a parameter set into the host buffer `plan`
// (dfd_decoder_boundary_plan_bytes bytes): the weights transposed (out-proj
// (W, W), c_fc (hidden, W), c_proj (W, hidden), in-proj (2W, W), each (N, K)
// contiguous bf16; null for an absent half), the biases and LayerNorms (f32; ln_2 scale,
// shift, ln_1 scale, shift) and the layout of
// ops/_cuda.py:boundary_geometry (the shared-memory offset of each stage's
// slices, the LayerNorms' parameters' and the tile's offsets, the launch's
// shared memory and grid; for the streamed form, kc > 0, the K values a
// chunk, the ring's slots, the bytes between a slot's rows and between
// slots, and the ring's offset).
extern "C" int dfd_decoder_boundary_plan(void* plan, const void* w_out, const void* w_fc,
                                         const void* w_proj, const void* w_in,
                                         const float* b_out, const float* b_fc,
                                         const float* b_proj, const float* b_in,
                                         const float* ln2_scale, const float* ln2_shift,
                                         const float* ln1_scale, const float* ln1_shift,
                                         int width, int hidden, const int* w_off, int ln_off,
                                         int a_off, int smem, int grid, int kc, int slots,
                                         int pitch, int slot_bytes, int ring_off) {
  if (kc > 0 && (slots < 1 || slots > MAX_SLOTS || kc % (KSTEP * WARPS) != 0 ||
                 kc > KSTEP * WARPS * MAX_CHUNK_KSTEPS || width > 256 * STREAM_LN_CHUNKS))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memset(&p, 0, sizeof(p));
  const void* w[kStages] = {w_out, w_fc, w_proj, w_in};
  const float* b[kStages] = {b_out, b_fc, b_proj, b_in};
  for (int s = 0; s < kStages; ++s) {
    p.w[s] = static_cast<const bf16*>(w[s]);
    p.bias[s] = b[s];
    p.w_off[s] = w_off[s];
  }
  p.ln[0] = ln2_scale;
  p.ln[1] = ln2_shift;
  p.ln[2] = ln1_scale;
  p.ln[3] = ln1_shift;
  p.width = width;
  p.hidden = hidden;
  p.ln_off = ln_off;
  p.a_off = a_off;
  p.smem = smem;
  p.grid = grid;
  p.kc = kc;
  p.slots = slots;
  p.pitch = pitch;
  p.slot_bytes = slot_bytes;
  p.ring_off = ring_off;
  memcpy(plan, &p, sizeof(p));
  return 0;
}

// One boundary on `rows` rows of x (B, W) and, with tail, o (B, W) (bf16,
// contiguous), with a plan of dfd_decoder_boundary_plan (its form's kernel),
// into x_out (B, W)
// (tail) and qrow (B, 2W) (query). scratch: bf16 of B x (W + hidden)
// values, [x1 (B, W) | mid (B, hidden)], the intermediates. barrier: a
// 32-bit counter, 0 before the first launch on the stream (it is 0 again
// after each). clock: null, or a zeroed u64 buffer of grid x 21 entries for
// the stage clock. Returns -1 without launching when the plan's grid cannot
// be co-resident, else the launch's CUDA error code.
extern "C" int dfd_decoder_boundary(const void* plan, const void* x, const void* o, void* x_out,
                                    void* qrow, void* scratch, unsigned* barrier, void* clock,
                                    int rows, int tail, int query, void* stream) {
  Args a;
  memcpy(&a.p, plan, sizeof(Plan));
  if (rows < 1 || !(tail || query)) return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.o = static_cast<const bf16*>(o);
  a.x_out = static_cast<bf16*>(x_out);
  a.qrow = static_cast<bf16*>(qrow);
  a.x1 = static_cast<bf16*>(scratch);
  a.mid = a.x1 + (size_t)rows * a.p.width;
  a.barrier = barrier;
  a.clock = static_cast<unsigned long long*>(clock);
  a.rows = rows;
  a.tail = tail;
  a.query = query;
  const bool streamed = a.p.kc > 0;
  const auto kernel = streamed ? decoder_boundary_streamed_kernel : decoder_boundary_kernel;
  int& attribute = streamed ? stream_smem_attribute : smem_attribute;
  if (a.p.smem > attribute) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute = a.p.smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err == cudaErrorCooperativeLaunchTooLarge) {
    cudaGetLastError();
    return -1;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
