// The whole encoder tower in one persistent cooperative launch: layers
// 0..last of a CLIP ViT over a batch of frames, the kept layers' K/V
// exported into stacked (Lsel, N, T', W) buffers.
//
// Replaces: dfd_clip_tpu/ops/pallas_tower.py fused_encoder_tower
// (_make_tower_kernel, grid (chunks, layers) with the chunk's residual
// stream carried in VMEM scratch across the layer steps). It computes the
// per-layer whole-block chain exactly: each layer below `last` is
// _make_full_block_kernel's block (LN1, qkv + the K/V export on kept layers,
// attention, out-projection + residual into the f32 hmid, LN2, c_fc +
// QuickGELU, c_proj + hmid, rounded to bf16 between layers), in bf16 or
// W8A8 (the out-projection W8A8 too, DFD_INT8_WO's default) with the
// attention in bf16 or int8 (_attn_int8_cols, modes "1" and "qk"); the last
// kept layer runs LN1 and the K/V columns of its qkv projection only. The
// export is unpadded (T' = T - drop_cls).
//
// Bound on an H100: the sum of the per-layer blocks' bounds (tensor-core
// operations of the four products and the attention); what the tower can
// save over the per-layer chain is the launches and the device-memory round
// trips of the residual stream and the intermediates between them.
//
// Design: one cooperative launch (cudaLaunchKernelEx with the cooperative
// attribute) of 384-thread blocks in clusters of two, one block a SM, as
// many clusters as are co-resident (cudaOccupancyMaxActiveClusters: 66 on
// an H100 SXM); a grid that cannot be co-resident is refused before launch,
// never run another way. The kernel walks the batch in chunks of frames with
// the layers innermost, as the TPU grid does; each stage of a layer ends in
// a grid barrier (an arrival counter with the same watchdog as the
// mbarriers). The stages run the per-layer kernels' own bodies, so the tower
// sums and rounds where the per-layer chain does, bit for bit:
// - the four products on the GEMM frame of csrc/gemm_hopper.cuh with the
//   per-layer kernels' Op types and epilogue forms (csrc/gemm_ops.cuh):
//   warpgroup 0 produces (TMA, 56 registers; its warps 1-3 store the bf16
//   tiles and the K/V export), warpgroups 1 and 2 consume (wgmma, 224
//   registers), 128 x 256 tiles, each cluster's two CTAs sharing the
//   weight's tiles by TMA multicast;
// - the bf16 attention on the body of csrc/encoder_attention.cu
//   (csrc/attention_hopper.cuh) with the same block: its producers on
//   warps 0 and 1, two consumer warpgroups where the per-layer kernel has
//   three (a query tile walks its keys in the same blocks of 64 either way);
// - the row stages (LN1, LN2, each with the row quantisation on the int8
//   tower, and the quantisation of the attention output and of the MLP
//   intermediate: csrc/rows.cuh, a row a warp) on every warp, a LayerNorm's
//   scale and shift staged in shared memory (the L1 that the stages' shared
//   memory leaves is too small to keep them beside the streaming rows);
// - the int8 attention on the body of csrc/encoder_attention_s8.cu
//   (csrc/attention_s8_hopper.cuh) with the same block: its producers on
//   warps 0 and 1, its quantisers on warps 2 and 3, the two consumer
//   warpgroups; a query tile's values do not depend on the consumer count.
// The warpgroups keep one role for the whole launch: setmaxnreg moves the
// producer's registers to the consumers once, in the branch that runs each
// role (a role's code after a join would get the smaller count), and each
// role's branch walks the chunks, layers and stages itself, meeting the
// other at every grid barrier. The mbarriers are initialised once and keep
// their phases across stages: every role carries its ring and staging
// counters from one stage to the next (hgemm::Counts, hattn::Counts), and a
// GEMM producer returns only when its cluster peer has released every ring
// stage. A stage writes with generic stores (the store warps, the
// attention's epilogue, the row stages) what the next one reads with TMA
// (the async proxy): every thread fences the proxies (fence.proxy.async)
// before each grid barrier.
//
// Tensor maps: the activations' (LN output or int8 rows, the attention
// output, the MLP intermediate; the attention's 3-D q, k, v views of the
// qkv scratch) cover the chunk's scratch, which is fixed for the launch,
// and are kernel parameters; the weights' differ by layer, 4 a layer,
// encoded on the host once a call (dfd_encoder_tower_table) into one device
// array beside the per-layer pointer table (LayerW) and read through a
// generic pointer, the producer prefetching them. The last chunk may be
// short: its products walk its rows only (rows of a partial tile past them
// read stale scratch and store nothing).
//
// Memory: the wrapper allocates one chunk's scratch (h bf16, qkv bf16, the
// attention output, hmid f32, the MLP intermediate, the LayerNorm output or
// the int8 activations and their scales); the chunk plays the part of the
// TPU's VMEM hbuf. Its size is a fixed rule of the wrapper (ops/_cuda.py
// tower_chunk): the whole batch, up to 2^16 rows. A stage pays its ring's
// fill and drain, its last wave's tail and a grid barrier, so fewer,
// larger stages run faster; keeping a chunk's qkv in L2 (the earlier rule)
// and filling the clusters 1 to 8 times were both slower on an H100
// (PERF.md). The grid barriers a launch are chunks x (7 a layer, 9 on the
// int8 tower, and 2 for the last layer). A stage clock (TowerArgs.clock,
// null unless asked for) reads %globaltimer at each barrier.
//
// The kernel lives in csrc/encoder_tower.cuh; its four instantiations (bf16
// or int8; with or without the bf16 attention's N = 16 tail, the per-layer
// kernel's choice at the token count) are translation units of their own,
// compiled in parallel.
#include "encoder_tower.cuh"

using namespace tower;

// *grid = the largest co-resident grid of the tower kernel for this
// geometry, in blocks (clusters x 2; 0 when none can run: more shared
// memory than a block may have, or no cooperative launch on the device).
// Returns a CUDA error code.
extern "C" int dfd_encoder_tower_grid(int tokens, int int8, int attn, int* grid) {
  *grid = 0;
  auto kernel = tower_kernel(tokens, int8);
  const size_t smem = tower_smem(int8, attn);
  if (tokens < 1 || smem > SMEM_LIMIT) return 0;
  int dev = 0, sms = 0, coop = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = launch_config(int8, attn, sms / CL * CL, nullptr, attr);
  cfg.numAttrs = 1;   // the occupancy query takes the cluster shape alone
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = coop ? clusters * CL : 0;
  return 0;
}

// The weights' tensor maps of a call, into the host buffer `table`: 4 a
// layer (qkv, out-proj, c_fc, c_proj; the last layer's qkv map covers its
// K/V columns only), 128 bytes each, followed by the layers' LayerW records
// (nlayers x 16 pointers, which the caller has written). Returns 0, or
// cudaErrorInvalidValue when a map cannot be encoded.
extern "C" int dfd_encoder_tower_table(void* table, int nlayers, int width, int hidden,
                                       int int8) {
  CUtensorMap* maps = static_cast<CUtensorMap*>(table);
  const LayerW* layers = reinterpret_cast<const LayerW*>(maps + 4 * nlayers);
  const int W = width;
  const int kin[4] = {W, W, W, hidden}, nout[4] = {3 * W, W, hidden, W};
  for (int l = 0; l < nlayers; ++l)
    for (int i = 0; i < 4; ++i) {
      const bool kv_only = i == kQkv && l == nlayers - 1;
      const int off = kv_only ? W : 0, n = nout[i] - off, k = kin[i];
      bool ok;
      if (int8)   // (N, K) rows, boxes of 128 bytes x BN / CL rows
        ok = hopper::encode_2d(&maps[4 * l + i], CU_TENSOR_MAP_DATA_TYPE_UINT8,
                               static_cast<const int8_t*>(layers[l].w[i]) + (size_t)off * k, k, n,
                               k, hgemm::KBYTES, BN / CL);
      else   // (K, N) rows at a pitch of N, boxes of 64 x 64
        ok = hopper::encode_2d(&maps[4 * l + i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                               static_cast<const bf16*>(layers[l].w[i]) + off, n, k,
                               2LL * nout[i], 64, 64);
      if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    }
  return 0;
}

// The tower over h0 (frames * tokens, width) bf16 with `table`, the device
// copy of dfd_encoder_tower_table's buffer followed by a zeroed 32-bit word
// (the grid barrier's counter), exporting layers first..last into k, v
// (last - first + 1, frames, t_out, width) bf16. int8: the W8A8 tower
// (weights int8 (N, K) with (N,) scales); attn 0, 1, 2: bf16 attention,
// _attn_int8_cols, its qk mode (int8 only). The scratch pointers hold
// chunk * tokens rows each (see TowerArgs). grid 0 launches the largest
// co-resident grid; a larger grid, or none co-resident, returns -1 without
// launching; an odd grid (not whole clusters) is invalid. `clock`: null, or
// a zeroed u64 buffer of 2 + the launch's grid barriers for the stage clock
// (its count, then the %globaltimer readings: the start, each barrier).
// Otherwise returns the launch's CUDA error code.
extern "C" int dfd_encoder_tower(const void* h0, const void* table, void* k, void* v, int frames,
                                 int tokens, int width, int heads, int hidden, int first, int last,
                                 int lo, int t_out, int chunk, int int8, int attn, float scale,
                                 float coef_qk, void* h, void* qkv, void* att, void* hmid,
                                 void* mid, void* y, void* aq, void* as, int grid, void* clock,
                                 void* stream) {
  int max_grid = 0;
  const int err = dfd_encoder_tower_grid(tokens, int8, attn, &max_grid);
  if (err != 0) return err;
  if (max_grid < 1 || grid > max_grid) return -1;
  if (grid % CL || chunk < 1 || frames < 1 || hidden % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nlayers = last + 1;
  TowerArgs a{};
  const CUtensorMap* maps = static_cast<const CUtensorMap*>(table);
  a.wmaps = maps;
  a.layers = reinterpret_cast<const LayerW*>(maps + 4 * nlayers);
  a.barrier = const_cast<unsigned*>(reinterpret_cast<const unsigned*>(a.layers + nlayers));
  a.clock = static_cast<unsigned long long*>(clock);
  a.h0 = static_cast<const bf16*>(h0);
  a.k = static_cast<bf16*>(k);
  a.v = static_cast<bf16*>(v);
  a.frames = frames;
  a.tokens = tokens;
  a.width = width;
  a.heads = heads;
  a.hidden = hidden;
  a.first = first;
  a.last = last;
  a.lo = lo;
  a.t_out = t_out;
  a.chunk = chunk;
  a.attn = attn;
  a.coef = scale * hattn::LOG2E;
  a.coef_qk = coef_qk;
  a.h = static_cast<bf16*>(h);
  a.qkv = static_cast<bf16*>(qkv);
  a.att = att;
  a.hmid = static_cast<float*>(hmid);
  a.mid = mid;
  a.y = static_cast<bf16*>(y);
  a.aq = static_cast<int8_t*>(aq);
  a.as = static_cast<float*>(as);
  const long long rows = (long long)chunk * tokens;
  const int W = width;
  bool ok;
  if (int8)
    ok = hopper::encode_2d(&a.map_in, CU_TENSOR_MAP_DATA_TYPE_UINT8, aq, W, rows, W,
                           hgemm::KBYTES, hgemm::BM) &&
         hopper::encode_2d(&a.map_att, CU_TENSOR_MAP_DATA_TYPE_UINT8, aq, W, rows, W,
                           hgemm::KBYTES, hgemm::BM) &&
         hopper::encode_2d(&a.map_mid, CU_TENSOR_MAP_DATA_TYPE_UINT8, aq, hidden, rows, hidden,
                           hgemm::KBYTES, hgemm::BM);
  else
    ok = hopper::encode_2d(&a.map_in, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, W, rows, 2LL * W, 64,
                           hgemm::BM) &&
         hopper::encode_2d(&a.map_att, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, att, W, rows, 2LL * W,
                           64, hgemm::BM) &&
         hopper::encode_2d(&a.map_mid, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, mid, hidden, rows,
                           2LL * hidden, 64, hgemm::BM);
  const bf16* x = static_cast<const bf16*>(qkv);
  ok = ok && hattn::encode(&a.map_q, x, 3LL * W, chunk, tokens, heads) &&
       hattn::encode(&a.map_k, x + W, 3LL * W, chunk, tokens, heads) &&
       hattn::encode(&a.map_v, x + 2 * W, 3LL * W, chunk, tokens, heads);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config(int8, attn, grid > 0 ? grid : max_grid, stream, attr);
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, tower_kernel(tokens, int8), a);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}
