// The megakernel probe's chained product: `layers` times h = bf16(h @ W_l)
// over rows of width w, f32 accumulate, no bias. Two entries, both on the
// bf16 GEMM's persistent TMA / wgmma frame (csrc/gemm_hopper.cuh) for
// sm_90a.
//
// Replaces: tools/bench_megakernel_probe.py per_layer_calls (12 pallas
// calls, h through device memory between them: dfd_gemm_chain_layer, a
// launch a layer) and megakernel (one pallas call over the grid (chunks,
// layers), the chunk's h carried in the revisited output window:
// dfd_gemm_chain, one launch with the layer sweep inside).
//
// Bound on an H100 at the probe's (63040, 768) x (768, 768) x 12: 0.89
// TFLOP on the bf16 tensor cores (0.90 ms at 989 TFLOP/s) against 97 MB of
// h in, 97 MB out and 14 MB of weights (0.06 ms at 3.35 TB/s): operations.
//
// Both entries run the frame's roles unchanged: 128 x 256 output tiles in
// clusters of two CTAs that take two row panels at one column tile and
// share the weight's tile (TMA multicast), one producer thread, two
// consumer warpgroups (64 rows each, wgmma m64n256k16 with K in steps of 16
// from 0 and the accumulator from zero, one bf16 rounding), three store
// warps that store a tile from shared memory while the next one's products
// run. So the two entries' results are bit-equal. Both take 256-column
// tiles at every row count (the GEMM wrapper takes 64 where M is small).
//
// The per-layer entry is the frame's plain kernel without a bias, h through
// device memory between its launches: 11 extra round trips of 97 MB each
// way at the probe's shape (2.1 GB, 0.64 ms at 3.35 TB/s, under its
// products), and a launch's fill and tail a layer.
//
// The megakernel keeps each pair of row panels in one cluster for all the
// layers: a cluster walks the pairs with a static stride, and for each
// runs every layer's column tiles before the next pair. A layer's output
// goes through L2 to the next layer's A loads in the same launch, in two
// (R, w) buffers that alternate (the output for the last layer): 128 rows
// x w of each a CTA (384 KB at w = 768, 50 MB over the card's 132 CTAs),
// against 50 MB of L2. A CTA waits on its own panel's previous layer only
// (no grid barrier, no cooperative launch), and only where it needs it:
// the store warps keep C in L2 with plain stores (the per-layer entry
// streams it out), make each tile visible to the async proxy
// (fence.proxy.async.global) and arrive on a barrier of its column tile;
// the producer waits on column tile t of the previous layer just before its
// first load of A's k-blocks 4t .. 4t + 3, so the layer's first tiles load
// while its last tile is still being stored. The layers a CTA runs, counted
// across its units, alternate between two sets of these barriers, so that
// a barrier is never two phases behind the one waited for (a parity wait
// could not tell the two apart): before the wait for layer p, the wait for
// layer p - 1 or p - 2 has passed, and layer p + 2 needs this wait's loads.
// Rows past R read zeros and store nothing, in both entries. Every mbarrier
// wait traps after 2^26 polls (csrc/hopper.cuh).
#include "gemm_ops.cuh"

namespace {

using namespace hgemm;

constexpr int TILE_N = 256;                    // both entries' tile width
using ChainLayout = Layout<TILE_N>;
constexpr int CL = ChainLayout::CLUSTER;       // CTAs a cluster: two row panels
constexpr int MAX_W = 768;
constexpr int MAX_TILES = MAX_W / TILE_N;      // column tiles of a layer
constexpr int KBLOCKS = TILE_N / 64;           // A's k-blocks a column tile of output holds
// the frame's layout, then two sets of a barrier a column tile (that tile of
// the layer stored), for the layers of even and of odd index
constexpr int STORED_OFF = ChainLayout::BAR_OFF + ChainLayout::BAR_BYTES;
constexpr int CHAIN_SMEM = ChainLayout::SMEM_BYTES + 2 * 8 * MAX_TILES;
static_assert(CHAIN_SMEM <= 232448, "more shared memory than a block may have");

struct ChainArgs {
  int rows, w, layers;
  int units;     // row-panel pairs: ceil(ceil(rows / BM) / CL)
  bf16* out;     // the last layer's output, and every second layer's before it
  bf16* other;   // the other layers' outputs
};

// Layer l writes `out` when an even number of layers follow it.
__device__ __forceinline__ bool to_out(const ChainArgs& a, int l) {
  return (a.layers - 1 - l) % 2 == 0;
}

__device__ __forceinline__ BF16Op::Params layer_params(const ChainArgs& a, int l) {
  return BF16Op::Params{Out{to_out(a, l) ? a.out : a.other, nullptr, a.w, 0, a.rows, a.w,
                            BF16Op::kStore, false, true, Export{}},
                        nullptr};
}

// The barrier of column tile t that layer p of the CTA's walk (p = i x
// layers + l in its i-th unit) arrives on, and the parity of that layer's
// phase on it.
__device__ __forceinline__ uint32_t stored_bar(uint32_t stored, uint32_t p, int t) {
  return stored + 8u * ((p & 1u) * MAX_TILES + t);
}
__device__ __forceinline__ uint32_t stored_parity(uint32_t p) { return (p >> 1) & 1u; }

// The walk of one layer of the pair u: its column tiles, units u x tiles
// .. u x tiles + tiles - 1 of the frame's walk (stride 1, from u x tiles).
__device__ __forceinline__ Walk layer_walk(const ChainArgs& a, int u) {
  const int tiles = (a.w + TILE_N - 1) / TILE_N;
  return Walk{tiles, (u + 1) * tiles, a.w / 64};
}

// The TMA thread: the frame's stages (A's 128 rows and the weight's 64 x
// 256 tile, half of it into both CTAs of the cluster), A from h in the
// first layer and from the previous layer's output after, the weight rows
// of layer l; before its first load of each of A's column tiles in a layer,
// that tile of the previous layer stored. Then it waits until the peer's
// consumers have released the last stages, so that no arrival finds this
// CTA gone.
__device__ __forceinline__ void produce_chain(const Smem<TILE_N>& sm, const ChainArgs& a,
                                              const CUtensorMap* mh, const CUtensorMap* mo,
                                              const CUtensorMap* mx, const CUtensorMap* mw,
                                              uint32_t stored, int rank, int unit0, int step) {
  constexpr int STAGES = ChainLayout::STAGES;
  constexpr int NB = TILE_N / 64 / CL;
  const int tiles = (a.w + TILE_N - 1) / TILE_N, ktiles = a.w / 64;
  int n = 0;        // stages loaded
  uint32_t i = 0;   // units walked
  for (int u = unit0; u < a.units; u += step, ++i) {
    const int m0 = (u * CL + rank) * BM;
    for (int l = 0; l < a.layers; ++l) {
      const CUtensorMap* ma = l == 0 ? mh : to_out(a, l - 1) ? mo : mx;
      const uint32_t p = i * a.layers + l - 1u;   // the previous layer of the walk
      for (int j = 0; j < tiles; ++j)
        for (int kt = 0; kt < ktiles; ++kt, ++n) {
          if (l > 0 && j == 0 && kt % KBLOCKS == 0)
            mbar_wait(stored_bar(stored, p, kt / KBLOCKS), stored_parity(p));
          const int s = n % STAGES;
          mbar_wait(sm.empty(s), ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(sm.full(s), ChainLayout::STAGE_BYTES);
          tma_load(sm.a(s), ma, sm.full(s), kt * 64, m0);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const int jj = rank * NB + b;
            tma_load_multicast(sm.b(s) + jj * 64 * KBYTES, mw, sm.full(s), j * TILE_N + 64 * jj,
                               l * a.w + kt * 64, (1 << CL) - 1);
          }
        }
    }
  }
  for (int s = 0; s < STAGES; ++s)
    mbar_wait(sm.empty((n + s) % STAGES), (((n + s) / STAGES) & 1) ^ 1);
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_chain_kernel(const __grid_constant__ CUtensorMap map_h,
                  const __grid_constant__ CUtensorMap map_out,
                  const __grid_constant__ CUtensorMap map_other,
                  const __grid_constant__ CUtensorMap map_w, const ChainArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t aligned = (raw + 1023u) & ~1023u;
  const int rank = static_cast<int>(cluster_rank());
  const Smem<TILE_N> sm{aligned, smem_raw + (aligned - raw), static_cast<uint32_t>(rank ^ 1),
                        aligned + ChainLayout::BAR_OFF};
  const uint32_t stored = aligned + STORED_OFF;
  if (threadIdx.x == 0) {
    sm.init();
    for (int t = 0; t < 2 * MAX_TILES; ++t) mbar_init(stored + 8u * t, 32 * STORE_WARPS);
    mbar_fence_init();
  }
  cluster_sync();   // the peer's barriers exist before it is written to
  const int unit0 = cluster_id(), step = cluster_count();
  const int warp = threadIdx.x / 32;
  Counts cnt;
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: the ring and the store warps ----------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      produce_chain(sm, a, &map_h, &map_out, &map_other, &map_w, stored, rank, unit0, step);
    } else if (warp >= 1 && warp <= STORE_WARPS) {
      uint32_t i = 0;   // units walked
      for (int u = unit0; u < a.units; u += step, ++i) {
        const Walk w = layer_walk(a, u);
        for (int l = 0; l < a.layers; ++l)
          store_tiles<BF16Op, TILE_N, kFormChain>(sm, w, layer_params(a, l).out, rank,
                                                  u * w.tiles_n, 1, cnt,
                                                  stored_bar(stored, i * a.layers + l, 0));
      }
    }
  } else {
    // ---- the consumer warpgroups, 64 rows of the tile each ---------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = threadIdx.x / 128 - 1;
    for (int u = unit0; u < a.units; u += step) {
      const Walk w = layer_walk(a, u);
      for (int l = 0; l < a.layers; ++l)
        consume<BF16Op, TILE_N, kFormChain>(sm, w, layer_params(a, l), c, rank, u * w.tiles_n, 1,
                                            cnt);
    }
  }
}

// The megakernel's co-resident clusters, read once (its attribute set
// then); -1 when none can be resident.
int chain_clusters(int* clusters) {
  static int most = 0;
  if (most == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(sms / CL * CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = CHAIN_SMEM;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int found = 0;
    err = cudaOccupancyMaxActiveClusters(&found, gemm_chain_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found < 1) return -1;
    most = found;
  }
  *clusters = most;
  return 0;
}

bool valid_width(int w) { return w >= 128 && w <= MAX_W && w % 128 == 0; }

// The megakernel's launch over (rows, w) and `layers` weights: its row
// panels, units (pairs of panels), column tiles a layer, the card's
// co-resident clusters and the grid in CTAs (a cluster a unit, at most the
// co-resident ones). Refuses what the kernel does not take.
struct ChainLaunch {
  int panels, units, tiles, clusters, grid;
};

int chain_launch(int rows, int w, int layers, ChainLaunch* g) {
  if (rows < 1 || layers < 1 || !valid_width(w) || (long long)layers * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  g->panels = (rows + BM - 1) / BM;
  g->units = (g->panels + CL - 1) / CL;
  g->tiles = (w + TILE_N - 1) / TILE_N;
  const int err = chain_clusters(&g->clusters);
  if (err != 0) return err;
  g->grid = (g->units < g->clusters ? g->units : g->clusters) * CL;
  return 0;
}

}  // namespace

// The megakernel's geometry on this card for (rows, w, layers): out[0..5]
// = row panels of 128, units (a cluster's two panels), column tiles of 256
// a layer, co-resident clusters of two, grid in CTAs, dynamic shared memory
// in bytes. Returns 0, or what dfd_gemm_chain would return.
extern "C" int dfd_gemm_chain_geometry(int rows, int w, int layers, int* out) {
  ChainLaunch g;
  const int err = chain_launch(rows, w, layers, &g);
  if (err != 0) return err;
  const int v[6] = {g.panels, g.units, g.tiles, g.clusters, g.grid, CHAIN_SMEM};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// out[rows, w] = h after `layers` products h = bf16(h @ ws[l]) in one
// launch, ws [layers, w, w], h, out and other contiguous bf16 (other
// (rows, w) scratch for the layers that do not write out; none aliases
// another); w a multiple of 128, at most 768. Returns the launch's
// cudaGetLastError(), or -1 when no cluster can be resident on this card.
extern "C" int dfd_gemm_chain(const void* h, void* out, void* other, const void* ws, int rows,
                              int w, int layers, void* stream) {
  ChainLaunch g;
  const int err = chain_launch(rows, w, layers, &g);
  if (err != 0) return err;
  alignas(64) CUtensorMap mh, mo, mx, mw;
  if (!encode_2d(&mh, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, w, rows, 2LL * w, 64, BM) ||
      !encode_2d(&mo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, w, rows, 2LL * w, 64, BM) ||
      !encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, other, w, rows, 2LL * w, 64, BM) ||
      !encode_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ws, w, (long long)layers * w, 2LL * w,
                 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChainArgs a{rows, w, layers, g.units, static_cast<bf16*>(out), static_cast<bf16*>(other)};
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(g.grid));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = CHAIN_SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_chain_kernel, mh, mo, mx, mw, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// out[rows, w] = bf16(h[rows, w] @ wl[w, w]), one launch of the frame's
// plain bf16 kernel without a bias (gemm_kernel<BF16Op, 256, 0>, which
// csrc/gemm.cu also runs), at 128 x 256 tiles whatever the row count; the
// same widths as dfd_gemm_chain.
extern "C" int dfd_gemm_chain_layer(const void* h, void* out, const void* wl, int rows, int w,
                                    void* stream) {
  if (rows < 1 || !valid_width(w)) return static_cast<int>(cudaErrorInvalidValue);
  int bn = 0, sms = 0;
  const int err = tile_n(rows, w, &bn, &sms);
  if (err != 0) return err;
  alignas(64) CUtensorMap ma, mb;
  if (!encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, w, rows, 2LL * w, 64, BM) ||
      !encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wl, w, w, 2LL * w, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const Out o{out, nullptr, w, 0, rows, w, BF16Op::kStore, false, true, Export{}};
  return launch_form<BF16Op, TILE_N, 0>(ma, mb, BF16Op::Params{o, nullptr}, rows, w, w, sms,
                                        stream);
}
