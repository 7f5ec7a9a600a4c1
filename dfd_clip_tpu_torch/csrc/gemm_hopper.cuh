// The frame shared by the bf16 and W8A8 GEMM kernels (csrc/gemm.cu,
// csrc/gemm_s8.cu): one persistent, warp-specialised sm_90a kernel a product
// type and epilogue form, over a 128 x BN output tile at a time. The design
// is described in gemm.cu; this header holds the tile walk, the TMA
// producer, the consumers' wgmma main loop, the epilogue's operands and
// staging, the store warps and the K/V export. An Op type (BF16Op or S8Op,
// csrc/gemm_ops.cuh) supplies the operand loads of a stage, its products and
// the f32 operations of the fused epilogue. The three roles are device
// functions (produce, store_tiles, consume, dispatched by walk_tiles) that
// gemm_kernel runs once and the whole-encoder tower (csrc/encoder_tower.cu)
// runs once a product stage: their ring and staging counters (Counts) carry
// from one call to the next, so the mbarriers keep their phases across the
// tower's stages and are initialised once a launch.
#pragma once

#include <utility>

#include "hopper.cuh"

namespace hgemm {

using namespace hopper;

constexpr int BM = 128;                    // output rows of a tile: NCONS x 64
constexpr int NCONS = 2;                   // consumer warpgroups
constexpr int THREADS = 128 * (NCONS + 1); // and the producer warpgroup
constexpr int KBYTES = 128;                // bytes of K a stage: one swizzle atom
constexpr int A_BYTES = BM * KBYTES;       // 16 KB
// setmaxnreg: the producer gives its registers to the consumers. A block
// starts with LAUNCH_REGS a thread (65,536 a SM); an increase that the
// decrease does not pay for never returns, so the two must balance.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 56;   // the TMA thread and the store warps
constexpr int CONSUMER_REGS = 224;
static_assert(LAUNCH_REGS - PRODUCER_REGS >= NCONS * (CONSUMER_REGS - LAUNCH_REGS),
              "setmaxnreg would wait for registers that are never freed");
// The epilogue takes the accumulator SLICE columns at a time. A bf16 tile
// goes whole into a shared staging tile (row pitch BN x 2 + 16 bytes) that
// the producer warpgroup's three idle warps (STORE_WARPS) store while the
// consumers run the next tile's products; an f32 tile goes through each
// warp's 16 rows x SLICE columns of that region (row pitch PITCH words),
// stored by the consumers themselves.
constexpr int SLICE = 32;
constexpr int PITCH = SLICE + 4;
constexpr int WARP_OUT_BYTES = 16 * PITCH * 4;
constexpr int STORE_WARPS = 3;

template <int BN>
struct Layout {
  // 128 x 256 tiles run in pairs of CTAs (a cluster) that take two row
  // panels at one column tile and share the weight's tile: each loads half
  // of it into both (TMA multicast). 128 x 64 tiles run alone.
  static constexpr int CLUSTER = BN == 256 ? 2 : 1;
  static constexpr int STAGES = BN == 256 ? 3 : 4;   // ring stages of A and B
  static constexpr int B_BYTES = BN * KBYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int OUT_OFF = STAGES * STAGE_BYTES;
  static constexpr int OUT_PITCH = BN * 2 + 16;   // bytes of a staged bf16 row
  static constexpr int OUT_BYTES = BM * OUT_PITCH > 8 * WARP_OUT_BYTES ? BM * OUT_PITCH
                                                                       : 8 * WARP_OUT_BYTES;
  // per consumer, two buffers (tiles alternate) of two per-column f32
  // operands (the bias; the W8A8 product's weight scale / 127)
  static constexpr int COL_OFF = OUT_OFF + OUT_BYTES;
  static constexpr int COL_BYTES = 2 * BN * 4;
  static constexpr int BAR_OFF = COL_OFF + NCONS * 2 * COL_BYTES;
  // full and empty barriers a stage and of the staging tile
  static constexpr int BAR_BYTES = (2 * STAGES + 2) * 8;
  // + 1024 for the base's alignment
  static constexpr int SMEM_BYTES = BAR_OFF + BAR_BYTES + 1024;
  static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");
};

// The K/V export of the qkv projection: the K and V columns (packed column
// col + col_off >= width) of every token row past `lo` go into slot views of
// the stacked (Lsel, N, T', W) buffers, and the row of each frame's last
// token also writes that frame's zero pad rows, so the buffers need no
// zeroing pass.
struct Export {
  bf16* k;          // slot base of the K buffer (N, T', W)
  bf16* v;          // slot base of the V buffer
  int tokens;       // T: token rows per frame in A
  int t_out;        // T': exported rows per frame (T - lo + pad)
  int lo;           // 1 drops the CLS row
  int width;        // W
  int col_off;      // column of C's first column in the packed [q|k|v] space
};

// The epilogue's compile-time form: the code of QuickGELU, of the residual
// and of the K/V export exists only in the kernels that run it, so that each
// kernel's epilogue stays small in the instruction cache. kFormRes: a
// residual added before the output's rounding, by the consumers;
// kFormResStore: a bf16 residual added to the rounded bf16 value, by the
// store warps (16-byte loads off the consumers' path); kFormChain: the
// store warps keep C in L2 (plain stores) and mark each stored tile for a
// TMA load of it later in the launch (csrc/gemm_chain.cu, whose next layer
// reads it as A).
enum : int {
  kFormGelu = 1,
  kFormRes = 2,
  kFormExport = 4,
  kFormOut32 = 8,
  kFormResStore = 16,
  kFormChain = 32
};

// The forms a kernel exists for, those the wrappers produce (ops/_cuda.py
// takes QuickGELU, a residual or the export, one at a time): a bf16 output
// plain, with QuickGELU, the export, a residual before the rounding or after
// it; an f32 output plain, with QuickGELU or with a residual.
constexpr int kForms[] = {0,          kFormGelu,  kFormExport, kFormRes, kFormResStore,
                          kFormOut32, kFormOut32 | kFormGelu, kFormOut32 | kFormRes};

// What every epilogue needs beside its Op's own operands.
struct Out {
  void* c;          // C (M, N) at row pitch ldc
  const void* res;  // the residual (M, N) at row pitch ldr, or null
  int ldc, ldr;
  int m, n;
  int flags;        // the Op's epilogue flags
  bool res_f32;     // the residual f32, else bf16
  bool store;       // write C
  Export ex;
};

// The K/V export of one row: its place in the slot views (computed once a
// tile) and eight neighbouring bf16 values (16 bytes) a call.
struct ExportRow {
  long long at;     // element offset of the row in a slot view, or -1 (a dropped row)
  long long pad0;   // ... of the frame's first pad row, when this is its last token
  long long pad1;   // ... past its last pad row (pad0 == pad1: no pad rows to write)
  __device__ void init(const Export& ex, int frame, int tok) {
    const long long base = (long long)frame * ex.t_out;
    at = tok >= ex.lo ? (base + tok - ex.lo) * ex.width : -1;
    pad0 = pad1 = 0;
    if (tok == ex.tokens - 1) {
      pad0 = (base + ex.tokens - ex.lo) * ex.width;
      pad1 = (base + ex.t_out) * ex.width;
    }
  }
  // C's columns col.. (packed column col + col_off >= width: K or V)
  __device__ void put(const Export& ex, int col, uint4 v) const {
    const int kv = col + ex.col_off - ex.width;
    if (kv < 0) return;
    const bool is_v = kv >= ex.width;
    bf16* dst = (is_v ? ex.v : ex.k) + (is_v ? kv - ex.width : kv);
    if (at >= 0) *reinterpret_cast<uint4*>(dst + at) = v;
    for (long long q = pad0; q < pad1; q += ex.width)
      *reinterpret_cast<uint4*>(dst + q) = make_uint4(0, 0, 0, 0);
  }
};

// ---- the products ------------------------------------------------------------------
// d (64 x N) (+)= A (64 x k, K-major) x B (k x N) from shared memory, one
// instruction; `accumulate` 0 overwrites d. bf16: k = 16, B MN-major
// (the weight's (K, N) rows, transposed by the instruction); int8: k = 32,
// B K-major (the weight stored (N, K)).
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86,"
      " %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52,"
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86,"
      " %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18,"
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---- the tile walk -------------------------------------------------------------------
// Work units in row panels of A, N fastest: unit u is column tile
// u % tiles_n of the CLUSTER row panels from (u / tiles_n) x CLUSTER, CTA
// `rank` of the cluster taking the rank-th (rows past M read 0 and store
// nothing). Cluster (or block) c takes units c, c + clusters, ... so the
// units in flight share a few A panels and the weight stays in L2.
struct Walk {
  int tiles_n, units, ktiles;
};

// Progress of a CTA's roles through the ring and the staging tile, carried
// from one walk_tiles call to the next (each thread keeps its own role's).
struct Counts {
  int loads = 0;    // ring stages filled (the producer) or consumed (a consumer)
  int staged = 0;   // bf16 tiles through the staging tile
};

template <int BN>
struct Smem {
  uint32_t base;        // shared address of the data, 1024-byte aligned
  unsigned char* ptr;   // the same, generic
  uint32_t peer;        // the other CTA of a cluster of two
  uint32_t bars;        // shared address of the Layout<BN>::BAR_BYTES of barriers
  static constexpr int STAGES = Layout<BN>::STAGES;
  __device__ uint32_t a(int s) const { return base + s * Layout<BN>::STAGE_BYTES; }
  __device__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (STAGES + s); }
  // the staging tile, full (the consumers wrote it) and empty (stored)
  __device__ uint32_t out_full() const { return bars + 8u * 2 * STAGES; }
  __device__ uint32_t out_empty() const { return out_full() + 8u; }
  __device__ unsigned char* out() const { return ptr + Layout<BN>::OUT_OFF; }
  // an f32 tile's per-warp slices (consumer c, its warp w)
  __device__ unsigned char* out(int c, int w) const {
    return out() + (4 * c + w) * WARP_OUT_BYTES;
  }
  __device__ float* cols(int c, int buf) const {
    return reinterpret_cast<float*>(ptr + Layout<BN>::COL_OFF +
                                    (2 * c + buf) * Layout<BN>::COL_BYTES);
  }
  // A warp is done with stage s: in a cluster both CTAs' consumers release
  // it, since both producers write into it.
  __device__ void release(int s) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      mbar_arrive(empty(s));
      if (Layout<BN>::CLUSTER > 1) mbar_arrive_cluster(map_rank(empty(s), peer));
    }
  }
  // One thread, once a launch; the caller then syncs the block (the
  // cluster, when CLUSTER > 1) before any role runs.
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NCONS * Layout<BN>::CLUSTER);   // each consumer warp of the cluster
    }
    mbar_init(out_full(), 128 * NCONS);       // each consumer thread
    mbar_init(out_empty(), 32 * STORE_WARPS);   // each store thread
    mbar_fence_init();
  }
};

// Two neighbouring values of the residual at (row, col), widened to f32.
__device__ __forceinline__ float2 load_res2(const Out& o, int row, int col) {
  const size_t at = (size_t)row * o.ldr + col;
  if (o.res_f32) return *reinterpret_cast<const float2*>(static_cast<const float*>(o.res) + at);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      static_cast<const bf16*>(o.res) + at));
}

// Consumer c (0 or 1): rows c x 64.. of each of the CTA's tiles.
// - At a tile's start it fetches the tile's per-column operands into shared
//   memory (cp.async) and its rows' scales into registers, so that the
//   epilogue waits on no load but the residual's.
// - The accumulator stays in registers through the K loop; each stage's
//   group is waited for and the stage released at once (a stage sooner than
//   keeping one group in flight, which the three-stage ring needs), while
//   the other consumer's group keeps the tensor cores busy.
// - Epilogue, SLICE columns at a time (unrolled: the accumulator's registers
//   are named at compile time), each warp on its own 16 rows: the Op's f32
//   operations on the accumulator's own register layout (each lane two
//   neighbouring columns of two rows; the residual loaded a slice ahead).
//   A bf16 tile goes into the staging tile for the store warps; an f32 tile
//   through the warp's slice, read back as eight neighbouring values of a
//   row a lane for 16-byte stores.
template <class Op, int BN, int FORM>
__device__ __forceinline__ void consume(const Smem<BN>& sm, const Walk& w,
                                        const typename Op::Params& p, int c, int rank,
                                        int unit0, int step, Counts& cnt) {
  using Acc = typename Op::Acc;
  constexpr int CL = Layout<BN>::CLUSTER;
  constexpr int STAGES = Layout<BN>::STAGES;
  constexpr int NSL = BN / SLICE;
  constexpr int PER = SLICE / 2;                  // accumulators a lane holds in a slice
  const Out& o = p.out;
  Acc acc[BN / 2];
  const int tid = threadIdx.x % 128;
  const int wq = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;        // accumulator row group and column pair
  unsigned char* stage = sm.out(c, wq);
  // the staging tile's rows of this lane (rows gr and gr + 8 of the warp)
  unsigned char* tile_row = sm.out() + (c * 64 + wq * 16 + gr) * Layout<BN>::OUT_PITCH;
  int n = cnt.loads;                             // stages consumed so far
  for (int u = unit0, i = 0; u < w.units; u += step, ++i) {
    const int m0 = (u / w.tiles_n * CL + rank) * BM, n0 = u % w.tiles_n * BN;
    float* cols = sm.cols(c, i & 1);
    for (int q = tid; q < 2 * BN / 4; q += 128) {
      const float* src = Op::col_src(p, q / (BN / 4));
      const int col = n0 + q % (BN / 4) * 4;
      const bool ok = src != nullptr && col < o.n;
      cp_async16(cols + q * 4, ok ? src + col : Op::col_src(p, 0), ok);
    }
    cp_async_commit();
    // lane: rows gr and gr + 8 of the warp's 16
    const int row0 = m0 + c * 64 + wq * 16 + gr;
    float scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      scale[h] = row0 + 8 * h < o.m ? Op::row_scale(p, row0 + 8 * h) : 0.f;
    if (FORM & kFormRes) {
      // the residual of this lane's two rows into L2 while the products run
      // (a line of 128 bytes a prefetch)
      const int esz = o.res_f32 ? 4 : 2;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        for (int q = t * 128 / esz; q < BN && row0 + 8 * h < o.m && n0 + q < o.n;
             q += 4 * 128 / esz)
          prefetch_l2(static_cast<const char*>(o.res) +
                      ((size_t)(row0 + 8 * h) * o.ldr + n0 + q) * esz);
    }

    for (int kt = 0; kt < w.ktiles; ++kt, ++n) {
      const int s = n % STAGES;
      mbar_wait(sm.full(s), (n / STAGES) & 1);
      fence_regs(acc);
      wgmma_fence();
      Op::template mma<BN>(acc, sm.a(s) + c * 64 * KBYTES, sm.b(s), kt);
      wgmma_commit();
      // the stage goes back to the producer as soon as its products are
      // done; the other consumer's group keeps the tensor cores busy
      wgmma_wait<0>();
      fence_regs(acc);
      sm.release(s);
    }
    // the column operands in, and the staging tile stored
    cp_async_wait<0>();
    for (int q = tid; q < 2 * BN / 4; q += 128)
      if (q >= BN / 4) Op::prepare_col1(cols + q * 4);   // this thread's own copy
    named_barrier(1 + c, 128);   // the tile's column operands are in
    if constexpr (!(FORM & kFormOut32)) mbar_wait(sm.out_empty(), (cnt.staged & 1) ^ 1);

    // The residual of a slice in the accumulator's layout (value i of
    // the slice: pair jj = i / 4, row h = i / 2 % 2, column e = i % 2),
    // loaded a slice ahead.
    float res[PER];
    auto load_res = [&](int sl) {
#pragma unroll
      for (int jj = 0; jj < SLICE / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h, col = n0 + sl * SLICE + 8 * jj + 2 * t;
          if (o.res != nullptr && row < o.m && col < o.n) {
            const float2 r = load_res2(o, row, col);
            res[4 * jj + 2 * h] = r.x;
            res[4 * jj + 2 * h + 1] = r.y;
          }
        }
    };
    if (FORM & kFormRes) load_res(0);
#pragma unroll
    for (int sl = 0; sl < NSL; ++sl) {
      Acc x[PER];
      float b[PER], wc[PER], ar[PER], r[PER], v[PER];
#pragma unroll
      for (int jj = 0; jj < SLICE / 8; ++jj) {
        const int cl = sl * SLICE + 8 * jj + 2 * t;
        const float2 c0 = *reinterpret_cast<const float2*>(cols + cl);
        const float2 c1 = *reinterpret_cast<const float2*>(cols + BN + cl);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          x[i] = acc[sl * PER + i];
          b[i] = e & 1 ? c0.y : c0.x;
          wc[i] = e & 1 ? c1.y : c1.x;
          ar[i] = scale[e / 2];
          r[i] = res[i];
        }
      }
      if ((FORM & kFormRes) && sl + 1 < NSL) load_res(sl + 1);
      Op::template apply<FORM>(p, x, b, wc, ar, r, v);
      if constexpr (!(FORM & kFormOut32)) {
        // bf16: into the staging tile, stored by the store warps
#pragma unroll
        for (int jj = 0; jj < SLICE / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(tile_row + 8 * h * Layout<BN>::OUT_PITCH +
                                               (sl * SLICE + 8 * jj + 2 * t) * 2) =
                __floats2bfloat162_rn(v[4 * jj + 2 * h], v[4 * jj + 2 * h + 1]);
        continue;
      }
      __syncwarp();   // the last slice's reads are done
#pragma unroll
      for (int jj = 0; jj < SLICE / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned char* at = stage + (gr + 8 * h) * PITCH * 4;
          const float v0 = v[4 * jj + 2 * h], v1 = v[4 * jj + 2 * h + 1];
          *reinterpret_cast<float2*>(at + (8 * jj + 2 * t) * 4) = make_float2(v0, v1);
        }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = n0 + sl * SLICE + 8 * t;
        if (row >= o.m || col >= o.n) continue;
        const unsigned char* at = stage + (gr + 8 * h) * PITCH * 4;
        const float4 lo = *reinterpret_cast<const float4*>(at + t * 32);
        const float4 hi = *reinterpret_cast<const float4*>(at + t * 32 + 16);
        if (o.store) {
          float4* dst =
              reinterpret_cast<float4*>(static_cast<float*>(o.c) + (size_t)row * o.ldc + col);
          __stcs(dst, lo);
          __stcs(dst + 1, hi);
        }
      }
    }
    if constexpr (!(FORM & kFormOut32)) {
      mbar_arrive(sm.out_full());   // every thread's writes
      ++cnt.staged;
    }
  }
  cnt.loads = n;
}

// The store warps: each bf16 tile from the staging tile to C, with the
// bf16 residual added after the rounding (kFormResStore) and, on the qkv
// projection, into the K/V export, while the consumers run the next tile's
// products. A warp takes whole rows (16 bytes a lane, 32 / (BN / 8) rows a
// step) and follows their (frame, token) by increments, without a division
// a row. With kFormChain each thread then makes its stores visible to the
// async proxy and arrives on the mbarrier at `stored` + 8 x the tile's
// column index (32 x STORE_WARPS arrivals a tile).
template <class Op, int BN, int FORM>
__device__ __forceinline__ void store_tiles(const Smem<BN>& sm, const Walk& w, const Out& o,
                                            int rank, int unit0, int step, Counts& cnt,
                                            uint32_t stored = 0) {
  constexpr int CL = Layout<BN>::CLUSTER;
  constexpr int CHUNKS = BN / 8;                 // 16-byte chunks of a row
  constexpr int PER = 32 / CHUNKS;               // rows a warp stores a step
  constexpr int STRIDE = PER * STORE_WARPS;      // rows between a warp's steps
  constexpr int BATCH = 4;                       // steps whose loads go out together
  const int sw = threadIdx.x / 32 - 1;           // warps 1 .. STORE_WARPS
  const int lane = threadIdx.x % 32;
  const int r0 = sw * PER + lane / CHUNKS, cc = lane % CHUNKS * 8;
  for (int u = unit0; u < w.units; u += step, ++cnt.staged) {
    const int m0 = (u / w.tiles_n * CL + rank) * BM, n0 = u % w.tiles_n * BN;
    const int col = n0 + cc;
    int frame = 0, tok = 0;
    if (FORM & kFormExport) {
      frame = (m0 + r0) / o.ex.tokens;
      tok = (m0 + r0) % o.ex.tokens;
    }
    mbar_wait(sm.out_full(), cnt.staged & 1);
    for (int r = r0; r < BM; r += BATCH * STRIDE) {
      // BATCH rows' staged values and residuals loaded first, then stored
      Pack8 v[BATCH], res[BATCH];
      bool ok[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int rq = r + q * STRIDE, row = m0 + rq;
        ok[q] = rq < BM && row < o.m && col < o.n;
        if (ok[q]) {
          v[q].u = *reinterpret_cast<const uint4*>(sm.out() + rq * Layout<BN>::OUT_PITCH + cc * 2);
          if (FORM & kFormResStore)
            res[q].u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(o.res) +
                                                       (size_t)row * o.ldr + col);
        }
      }
#pragma unroll
      for (int q = 0; q < BATCH; ++q) {
        const int row = m0 + r + q * STRIDE;
        if (ok[q]) {
          if (FORM & kFormResStore) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[q].h[e] =
                  __float2bfloat16(__bfloat162float(res[q].h[e]) + __bfloat162float(v[q].h[e]));
          }
          if (FORM & kFormChain)
            *reinterpret_cast<uint4*>(static_cast<bf16*>(o.c) + (size_t)row * o.ldc + col) =
                v[q].u;
          else if (o.store)
            __stcs(reinterpret_cast<uint4*>(static_cast<bf16*>(o.c) + (size_t)row * o.ldc + col),
                   v[q].u);
          if (FORM & kFormExport) {
            ExportRow ex;
            ex.init(o.ex, frame, tok);
            ex.put(o.ex, col, v[q].u);
          }
        }
        if (FORM & kFormExport) {
          for (tok += STRIDE; tok >= o.ex.tokens; tok -= o.ex.tokens) ++frame;
        }
      }
    }
    if constexpr ((FORM & kFormChain) != 0) {
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      mbar_arrive(stored + 8u * (u % w.tiles_n));
    }
    mbar_arrive(sm.out_empty());   // every thread is past its reads
  }
}

// The TMA thread: the ring of A's and the weight's tiles, through the
// tensor maps at ma and mb (kernel parameters, or a device array of them).
// In a cluster the peer's consumers release this CTA's stages too: before
// it returns it waits until the last of them has (the waits of the next
// fills, without taking those stages), so that no arrival finds the CTA
// gone, or, in the tower, the ring a product behind.
template <class Op, int BN>
__device__ __forceinline__ void produce(const Smem<BN>& sm, const Walk& w, const CUtensorMap* ma,
                                        const CUtensorMap* mb, int rank, int unit0, int step,
                                        Counts& cnt) {
  constexpr int CL = Layout<BN>::CLUSTER;
  constexpr int STAGES = Layout<BN>::STAGES;
  int n = cnt.loads;   // stages loaded so far
  for (int u = unit0; u < w.units; u += step) {
    const int m0 = (u / w.tiles_n * CL + rank) * BM, n0 = u % w.tiles_n * BN;
    for (int kt = 0; kt < w.ktiles; ++kt, ++n) {
      const int s = n % STAGES;
      mbar_wait(sm.empty(s), ((n / STAGES) & 1) ^ 1);
      mbar_expect_tx(sm.full(s), Layout<BN>::STAGE_BYTES);
      Op::template load<BN, CL>(sm.a(s), sm.b(s), ma, mb, sm.full(s), kt, m0, n0, rank);
    }
  }
  if (CL > 1)
    for (int i = 0; i < STAGES; ++i)
      mbar_wait(sm.empty((n + i) % STAGES), (((n + i) / STAGES) & 1) ^ 1);
  cnt.loads = n;
}

// The producer warpgroup's part of an M x N product: warp 0's first lane
// fills the ring, warps 1-3 store bf16 tiles. The consumer warpgroups run
// consume(warp / 4 - 1). The caller has set the warpgroups' registers
// (setmaxnreg, in the branch that runs the role: a role's code after the
// two branches join would get the smaller count) and initialised the
// barriers; each thread passes its own role's counters.
template <class Op, int BN, int FORM>
__device__ __forceinline__ void produce_tiles(const Smem<BN>& sm, const Walk& w,
                                              const CUtensorMap* ma, const CUtensorMap* mb,
                                              const Out& o, int rank, int unit0, int step,
                                              Counts& cnt) {
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0)
    produce<Op, BN>(sm, w, ma, mb, rank, unit0, step, cnt);
  else if (!(FORM & kFormOut32) && warp >= 1 && warp <= STORE_WARPS)
    store_tiles<Op, BN, FORM>(sm, w, o, rank, unit0, step, cnt);
}

// The walk of an M x N product, K deep, at tile width BN.
template <class Op, int BN>
__host__ __device__ inline Walk make_walk(int m, int n, int k) {
  constexpr int CL = Layout<BN>::CLUSTER;
  const int panels = ((m + BM - 1) / BM + CL - 1) / CL;
  return Walk{(n + BN - 1) / BN, panels * ((n + BN - 1) / BN),
              (k * Op::ELEM + KBYTES - 1) / KBYTES};
}

template <class Op, int BN, int FORM>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const typename Op::Params p, const Walk w) {
  constexpr int CL = Layout<BN>::CLUSTER;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const int rank = CL > 1 ? static_cast<int>(cluster_rank()) : 0;
  const Smem<BN> sm{aligned, smem_raw + (aligned - raw), static_cast<uint32_t>(rank ^ 1),
                    aligned + Layout<BN>::BAR_OFF};
  const int unit0 = CL > 1 ? cluster_id() : static_cast<int>(blockIdx.x);
  const int step = CL > 1 ? cluster_count() : static_cast<int>(gridDim.x);
  if (threadIdx.x == 0) sm.init();
  if (CL > 1) cluster_sync();   // the peer's barriers exist before it is written to
  else __syncthreads();
  Counts cnt;
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: the ring and the store warps ----------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    produce_tiles<Op, BN, FORM>(sm, w, &map_a, &map_b, p.out, rank, unit0, step, cnt);
  } else {
    // ---- the consumer warpgroups, 64 rows of the tile each ---------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<Op, BN, FORM>(sm, w, p, threadIdx.x / 128 - 1, rank, unit0, step, cnt);
  }
}

// The tile width of an M x N product: 256 columns, or 64 where the wide
// tiles would not give every SM one (the decoder's M = 16). 0 on success.
inline int tile_n(int m, int n, int* bn, int* sms) {
  static int sms_of[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = sms_of[dev];
  *bn = (long long)((m + BM - 1) / BM) * ((n + 255) / 256) >= *sms ? 256 : 64;
  return 0;
}

// One launch over M x N, K deep, at tile width BN (tile_n), with the tensor
// maps the caller encoded for it (the weight's boxes BN / CLUSTER wide). The
// kernel's attribute and its largest co-resident cluster count are set once.
template <class Op, int BN, int FORM>
int launch_form(const CUtensorMap& map_a, const CUtensorMap& map_b, const typename Op::Params& p,
                int m, int n, int k, int sms, void* stream) {
  constexpr int CL = Layout<BN>::CLUSTER;
  const long long panels = ((m + BM - 1) / BM + CL - 1) / CL;
  const long long units = panels * ((n + BN - 1) / BN);
  if (m < 1 || n < 1 || k < 1 || units > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Walk w = make_walk<Op, BN>(m, n, k);
  auto kernel = gemm_kernel<Op, BN, FORM>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Layout<BN>::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int clusters = 0;   // co-resident clusters (blocks when CL is 1)
  if (clusters == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Layout<BN>::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(sms / CL * CL);
    int most = 0;
    err = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    clusters = most > 0 ? most : sms / CL;
  }
  const long long grid = units < clusters ? units : clusters;
  cfg.gridDim = dim3(static_cast<unsigned>(grid * CL));
  cfg.numAttrs = CL > 1 ? 1 : 0;   // a lone CTA launches without the cluster attribute
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, p, w);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch of the form's kernel: a table of the kForms instantiations;
// any other form is refused.
template <class Op, int BN, size_t... I>
int launch_any(int form, const CUtensorMap& map_a, const CUtensorMap& map_b,
               const typename Op::Params& p, int m, int n, int k, int sms, void* stream,
               std::index_sequence<I...>) {
  using Fn = int (*)(const CUtensorMap&, const CUtensorMap&, const typename Op::Params&, int, int,
                     int, int, void*);
  static constexpr Fn table[] = {launch_form<Op, BN, kForms[I]>...};
  for (size_t i = 0; i < sizeof...(I); ++i)
    if (kForms[i] == form) return table[i](map_a, map_b, p, m, n, k, sms, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Op, int BN>
int launch(int form, const CUtensorMap& map_a, const CUtensorMap& map_b,
           const typename Op::Params& p, int m, int n, int k, int sms, void* stream) {
  return launch_any<Op, BN>(form, map_a, map_b, p, m, n, k, sms, stream,
                            std::make_index_sequence<sizeof(kForms) / sizeof(kForms[0])>{});
}

}  // namespace hgemm
