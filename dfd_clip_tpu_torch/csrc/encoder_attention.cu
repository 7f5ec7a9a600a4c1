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
// helpers live in csrc/hopper.cuh, shared with the GEMMs; the producers
// and consumers are device functions in csrc/attention_hopper.cuh, which
// the whole-encoder tower (csrc/encoder_tower.cu) runs with two consumer
// warpgroups as its attention stage.
#include "attention_hopper.cuh"

namespace {

using namespace hattn;

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
constexpr int SMEM_BYTES = Layout<NCONS>::DATA_BYTES + Layout<NCONS>::BAR_BYTES + 1024;

template <bool OUT_F32, bool NARROW>
__global__ void __launch_bounds__(THREADS, 1)
encoder_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, void* __restrict__ out,
                         const Geometry g, float coef) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Smem<NCONS> sm{base, base + Layout<NCONS>::DATA_BYTES};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) sm.init(g);
  __syncthreads();
  const Counts<NCONS> cnt{};
  if (warp < 4) {
    // ---- producer warpgroup: warp 0 the K/V ring, warp 1 the Q tiles --------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0)
      produce_kv(sm, g, &map_k, &map_v, cnt);
    else if (warp == 1 && lane == 0)
      produce_q(sm, g, &map_q, cnt);
  } else {
    // ---- the consumer warpgroups, 64 query rows each -------------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    consume_as<NCONS, OUT_F32, NARROW>(warp / 4 - 1, sm, g, coef, out, cnt);
  }
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
  const Geometry g = geometry<NCONS>(frames, tokens, heads);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block's load and slot counters are ints
  const long long per_block = (items + sms - 1) / sms;
  if (per_block * g.per_item > 0x7fffffffLL || per_block * g.slots > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool nr = narrow(tokens);
  auto kernel = out_f32 ? (nr ? encoder_attention_kernel<true, true>
                              : encoder_attention_kernel<true, false>)
                        : (nr ? encoder_attention_kernel<false, true>
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
