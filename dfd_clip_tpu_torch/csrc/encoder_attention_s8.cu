// Encoder self-attention with both attention products on the int8 tensor
// cores over packed bf16 qkv rows: one warp-specialised Hopper kernel (TMA
// loads, int8 wgmma) for every token count and both modes.
//
// Replaces: dfd_clip_tpu/ops/pallas_attention.py _attn_int8_cols (the
// DFD_INT8_ATTN stage of _make_full_block_kernel_phased and of
// pallas_tower.py's _make_tower_kernel). Q and K are quantised per (row,
// head) with s = max|x| + 1e-8 and q = clip(round(x * (127 / s))); the
// logits are (Qi Ki^T) * (sq * d^-1/2 / 127^2) * sk; the softmax
// probabilities P are quantised per row and V per channel of the head over
// all tokens of the frame; the output is (Pi Vi) * (sp / sum p / 127^2) * sv,
// f32 (frames x tokens, heads x 64), which the int8 block's out-projection
// quantises per row. Mode "qk" (qk_only) keeps PV in bf16: bf16(p) V with f32
// accumulate, times 1 / sum p. The softmax subtracts the row maximum (as
// csrc/encoder_attention.cu: the TPU kernel instead clamps logits at 60,
// pallas_attention.py:48-64; P's per-row quantisation is invariant to that
// factor except through the 1e-8 of its scale, so the two agree except where
// a logit exceeds 60 or a row's largest exp is below about 1e-6). The f32
// operations follow the JAX formula's order with __fmul_rn / IEEE division
// and expf, none fused into an FMA, so the plain version
// (ops/attention.py attn_int8_cols_plain) repeats them; only sum p is taken
// in another order (each thread two partial sums over its keys, by key group
// parity, block by block, then the four threads of a row).
//
// Bound on an H100: bytes. At ViT-B/16's (320 frames, 197 tokens, 12 x 64)
// the products are 2 x 197^2 x 64 x 2 operations per (frame, head) against
// 3 x 197 x 64 x 2 bytes of qkv read and 197 x 64 x 4 bytes of f32 written:
// about 100 int8 operations per byte, far below the card's ~590. At
// ViT-L/14@336px's (320, 577, 16 x 64) the same count gives ~290 a byte:
// 0.5644 ms of bytes (1.134 GB read, 0.756 GB written), 0.2205 ms of
// operations. What the card spends beyond that is the f32 work on each
// logit, twice (the row maximum, then exp, sum and P's quantisation), on the
// CUDA cores: about 20 instructions a logit, where the bf16 attention takes
// about 6.
//
// Design: the frame of csrc/encoder_attention.cu (csrc/attention_hopper.cuh),
// whose header describes the schedule. A persistent grid of one block a SM
// walks the work items, one (frame, head) each; warpgroup 0 produces
// (setmaxnreg down to 96 registers), two consumer warpgroups (up to 200)
// take a 64-row query tile each, across item boundaries. (Three consumers,
// as the bf16 attention has, ran slower on an H100: at 128 registers a
// thread the consumers' f32 work loses its parallelism and the quantisers
// spill.)
// - Loads: the bf16 attention's producers as they are: warp 0 keeps a ring
//   of STAGES = 10 key blocks of 64 (raw K and V, bf16, TMA boxes in the
//   128-byte swizzle) full, warp 1 the consumers' raw Q tiles (two buffers
//   each). Up to 640 tokens an item's whole K/V stays resident while its
//   query tiles walk it; above, the ring refills for each group of two
//   tiles, twice (one load a key block a pass).
// - Quantise once per (frame, head): producer warps 2 and 3 take V's
//   per-channel maxima over all the frame's tokens from device memory
//   first (16-byte loads, the maxima of the bf16 magnitudes' bits), then
//   quantise each key block as it lands, in place: K's row into bytes
//   0 .. 63 of its own 128-byte row (the int8 K-major B operand of S =
//   Q K^T) with its scale, then k_ready; V's channels (mode "1") into
//   bytes 64 .. 127 of the rows (V^T: each channel's keys contiguous, the
//   K-major B operand of PV) with the keys permuted to match P's register
//   fragment (kpos), then v_ready. The first pass needs only k_ready, and
//   an item's V^T does not wait for its last block.
// - A consumer quantises its Q tile in place (two threads a row, the warp
//   that holds the rows' A fragments), then two passes over the keys on
//   wgmma m64n32k32 s8 -> s32 (exact int32 sums), a key block in halves of
//   32 keys, A and B K-major from shared memory (32-byte steps inside the
//   swizzled rows), one half's product in flight while the other's f32
//   work runs:
//     pass 1 takes each row's maximum of the f32 logits;
//     pass 2 takes the same logits, p = exp(l - max), the row sums and P's
//     int8 values; max p is exp(0) = 1, so P's scale, 1 + 1e-8 (= 1 in f32),
//     is known before the row is complete. P goes from registers into the
//     PV product's A operand (wgmma m64n64k32 s8 with A from registers, a
//     k32 step a half). Mode "qk": bf16(p) through the bf16 attention's
//     wgmma_rs (m64n64k16, V's raw bf16 tile transposed by the
//     instruction).
//   Key groups of 8 wholly past the frame's end (the last block) skip the
//   f32 work; keys past it within a group are masked. Why two passes:
//   P's int8 values depend on the final row maximum, so an online softmax
//   with rescaling would give other values (and other bf16(p) in "qk").
// - The f32 work of a logit runs on the FMA pipes: P's rounding to int8
//   is an add of 1.5 x 2^23, whose low byte is the rounded value, where
//   the f32 -> int conversion (a quarter of the FMA rate on an H100) was
//   the largest cost after the exp.
// - Epilogue from the accumulator registers: (acc * cr) * sv or o * (1 /
//   sum p), f32, rows past the frame's end skipped; the tile's last key
//   block stays held until then, since its stage carries V's scales.
// Every mbarrier wait traps after ~2^26 polls, so a lost arrival ends the
// launch with an error instead of hanging the card.
//
// Shared memory: the bf16 attention's 10 x 16 KB ring and 2 x 2 x 8 KB Q
// buffers, 10 x 512 B of scales, 4 KB of the quantisers' partial maxima and
// the barriers, ~202 KB: one block a SM. The tensor maps are the bf16
// attention's (hattn::encode), passed as __grid_constant__ parameters. The
// body lives in csrc/attention_s8_hopper.cuh, which the whole-encoder tower
// (csrc/encoder_tower.cuh) runs with its two consumer warpgroups as its
// int8 attention stage: a query tile's values do not depend on the
// consumer count or on residency, so the two agree bit for bit.
#include "attention_s8_hopper.cuh"

namespace {

using namespace attn_s8;

constexpr int NCONS = 2;                     // consumer warpgroups, 64 query rows each
constexpr int THREADS = 128 * (NCONS + 1);   // and the producer warpgroup
// setmaxnreg: the producer gives registers to the consumers. A block starts
// with LAUNCH_REGS a thread (65,536 a SM); an increase that the decrease
// does not pay for never returns, so the two must balance.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 96;            // the TMA threads and the quantisers
constexpr int CONSUMER_REGS = 200;
static_assert(LAUNCH_REGS - PRODUCER_REGS >= NCONS * (CONSUMER_REGS - LAUNCH_REGS),
              "setmaxnreg would wait for registers that are never freed");
constexpr int SMEM_BYTES = Layout<NCONS>::DATA_BYTES + Layout<NCONS>::BAR_BYTES + 1024;
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");

template <bool QK>
__global__ void __launch_bounds__(THREADS, 1)
encoder_attention_s8_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const bf16* __restrict__ qkv, float* __restrict__ out,
                            const Geometry g, float coef_qk) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + Layout<NCONS>::DATA_BYTES;
  const Smem<NCONS> sm{{base, bars}, bars + hattn::Layout<NCONS>::BAR_BYTES,
                       smem_raw + (base - raw)};
  if (threadIdx.x == 0) {
    sm.a.init(g);
    sm.init_ready();
  }
  __syncthreads();
  const Counts<NCONS> cnt{};
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: the K/V ring, the Q tiles, the quantisers ----------
    setmaxnreg_dec<PRODUCER_REGS>();
    produce<NCONS, QK>(sm, g, &map_q, &map_k, &map_v, qkv, 3LL * g.heads * D, cnt);
  } else {
    // ---- the consumer warpgroups, 64 query rows each -------------------------------
    setmaxnreg_inc<CONSUMER_REGS>();
    consume_as<NCONS, QK, false>(threadIdx.x / 128 - 1, sm, g, coef_qk, out, cnt);
  }
}

}  // namespace

// out[frames * tokens, heads * 64] f32 = _attn_int8_cols over the packed
// bf16 rows qkv[frames * tokens, 3 * heads * 64], [q | k | v]; coef_qk =
// d^-1/2 / 127^2 rounded to f32; qk_only: PV in bf16. 16-byte aligned base
// (the wrapper checks; TMA needs it). Returns the launch's
// cudaGetLastError().
extern "C" int dfd_encoder_attention_s8(const void* qkv, void* out, int frames, int tokens,
                                        int heads, float coef_qk, int qk_only, void* stream) {
  const long long items = (long long)frames * heads;
  if (tokens < 1 || frames < 1 || heads < 1 || items > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long width = (long long)heads * D;
  const bf16* x = static_cast<const bf16*>(qkv);
  alignas(64) CUtensorMap mq, mk, mv;
  if (!hattn::encode(&mq, x, 3 * width, frames, tokens, heads) ||
      !hattn::encode(&mk, x + width, 3 * width, frames, tokens, heads) ||
      !hattn::encode(&mv, x + 2 * width, 3 * width, frames, tokens, heads))
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
  auto kernel = qk_only ? encoder_attention_s8_kernel<true> : encoder_attention_s8_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, x, static_cast<float*>(out), g, coef_qk);
  return static_cast<int>(cudaGetLastError());
}
