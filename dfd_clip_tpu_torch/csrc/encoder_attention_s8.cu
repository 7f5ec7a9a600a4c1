// Encoder self-attention with both attention products on the int8 tensor
// cores over packed bf16 qkv rows: one block per (frame, head) up to 320
// tokens, one per 128 query rows of a (frame, head) above.
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
// accumulate, times 1 / sum p.
//
// Bound on an H100: bytes. At ViT-B/16's (320 frames, 197 tokens, 12 x 64)
// the products are 2 x 197^2 x 64 x 2 operations per (frame, head) against
// 3 x 197 x 64 x 2 bytes of qkv read and 197 x 64 x 4 bytes of f32 written:
// about 100 int8 operations per byte, far below the card's ~590. At
// ViT-L/14@336px's (320, 577, 16 x 64) the same count gives ~290 a byte:
// 0.5644 ms of bytes (1.134 GB read, 0.756 GB written), 0.2205 ms of
// operations.
//
// Design: the block stages V (bf16) in shared memory with cp.async while
// its warps quantise K row by row (int8, 80-byte pitch as in gemm_s8, so the
// 32 lanes of a fragment load hit 32 banks); in mode "1" it then takes V's
// per-channel maxima and stores V quantised and transposed (each channel's
// tokens contiguous: the k-contiguous B operand of the PV product). Each warp
// walks 16-query-row tiles: Q quantised per row in registers, the logits by
// mma.sync m16n8k32 s8 -> s32 (exact int32 sums) into an f32 row buffer, a
// softmax with the row maximum subtracted (as csrc/encoder_attention.cu: the
// TPU kernel instead clamps logits at 60, pallas_attention.py:48-64; P's
// per-row quantisation is invariant to that factor except through the
// 1e-8 of its scale, so the two agree except where a logit exceeds 60 or a
// row's largest exp is below about 1e-6), P written back over the consumed
// logits (int8, or bf16 in mode "qk"), then PV by m16n8k32 s8 (or wmma bf16
// in mode "qk") and the dequant straight from the accumulator registers.
// Keys are padded to 32 with zero K rows, -inf logits, zero P and zero V.
// The TPU tower pads tokens to a multiple of 8 and masks the pad keys
// (kv_len); the port does not pad, so it needs no mask. The f32 operations
// follow the JAX formula's order and use __fmul_rn / __fadd_rn / IEEE
// division, so none is fused into an FMA and the plain version
// (ops/attention.py attn_int8_cols_plain) repeats them. The block body lives
// in csrc/attention_s8_tile.cuh, shared with csrc/encoder_tower.cu.
//
// Above 320 tokens (CLIP ViT-L/14@336px: 577) the launcher takes the
// streamed body (attn_s8::stream_tile) instead; up to 320 the staged kernel
// runs as before, bit for bit. A whole (frame, head) no longer fits one
// block: at 608 padded keys V (bf16), V^T and K (int8) alone take ~179 KB,
// which leaves room for one warp's logits row. Neither scale lets the
// attention stream as an online softmax does: V's per-channel scale is a
// maximum over all the frame's tokens, and P is quantised per row after
// the row maximum is subtracted, so a running maximum would give other
// int8 values. The streamed body instead takes a work item of 128 query
// rows of a (frame, head), 8 warps of 16 rows (grid: frames x heads x
// ceil(tokens / 128) blocks of 256 threads), and two passes over K:
//   - mode "1" first takes V's per-channel maxima over all tokens from
//     device memory (8 channels a thread, 16-byte loads, 32 row lanes);
//   - the keys then stream through shared memory in segments of 256: each
//     segment's K is quantised per row (int8, the staged body's arithmetic)
//     by the whole block; pass 1 takes the logits of every segment on the
//     int8 tensor cores (m16n8k32, exact int32 sums, scaled in f32 as the
//     staged body scales them) and keeps each row's maximum in registers;
//   - pass 2 takes the same logits again, p = exp(l - max), the row sums,
//     and P's int8 values. max p is exp(0) = 1, so P's per-row scale,
//     max p + 1e-8, is known before the row is complete. P goes from the
//     logits' accumulator registers straight into the PV product's A
//     fragments: a thread holds keys 2t, 2t + 1, 8 + 2t, 9 + 2t of each
//     16, the fragment wants k = 4t .. 4t + 3, so each segment's V^T
//     (quantised with the scales of the first step) is stored with its keys in that
//     permutation, which the exact int32 sum does not see. Mode "qk" stages
//     the segment's V rows (bf16) instead and multiplies bf16(p) into them
//     with mma.sync m16n8k16 (the streamed bf16 attention's fragments).
// Shared memory is 57 KB ("1") or 68 KB ("qk") at any token count, so the
// token count is capped only by the grid; three blocks fit a SM. Each block
// re-reads its (frame, head)'s K and V (L2 hits: the item's blocks are
// neighbours in the grid). The f32 operations are the staged body's; only
// the row sums are added in another order.
#include "attention_s8_tile.cuh"

namespace {

using namespace attn_s8;

template <int MAX_TP, bool QK_ONLY>
__global__ void encoder_attention_s8_kernel(const bf16* __restrict__ qkv, float* __restrict__ out,
                                            int tokens, int heads, float coef_qk) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile<MAX_TP, QK_ONLY>(qkv, 3 * heads * D, out, tokens, heads, coef_qk, blockIdx.x / heads,
                        blockIdx.x % heads, smem);
}

template <bool QK_ONLY>
__global__ void __launch_bounds__(STREAM_THREADS)
encoder_attention_s8_stream_kernel(const bf16* __restrict__ qkv, float* __restrict__ out,
                                   int tokens, int heads, float coef_qk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunks = (tokens + STREAM_ROWS - 1) / STREAM_ROWS;
  const int fh = blockIdx.x / chunks;
  stream_tile<QK_ONLY>(qkv, 3 * heads * D, out, tokens, heads, coef_qk, fh / heads, fh % heads,
                       blockIdx.x % chunks, smem);
}

int launch_stream(const void* qkv, void* out, int frames, int tokens, int heads, float coef_qk,
                  int qk_only, void* stream) {
  const long long blocks =
      (long long)frames * heads * ((tokens + STREAM_ROWS - 1) / STREAM_ROWS);
  if (blocks < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = qk_only ? encoder_attention_s8_stream_kernel<true>
                        : encoder_attention_s8_stream_kernel<false>;
  const size_t smem = stream_smem(qk_only);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), STREAM_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const bf16*>(qkv),
                                                 static_cast<float*>(out), tokens, heads, coef_qk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[frames * tokens, heads * 64] f32 = _attn_int8_cols over the packed
// bf16 rows qkv[frames * tokens, 3 * heads * 64], [q | k | v]; coef_qk =
// d^-1/2 / 127^2 rounded to f32; qk_only: PV in bf16. Up to 320 tokens the
// staged kernel runs, above it the streamed one. Returns the launch's
// cudaGetLastError().
extern "C" int dfd_encoder_attention_s8(const void* qkv, void* out, int frames, int tokens,
                                        int heads, float coef_qk, int qk_only, void* stream) {
  if (tokens > MAX_TOKENS)
    return launch_stream(qkv, out, frames, tokens, heads, coef_qk, qk_only, stream);
  if (tokens < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(tokens);
  auto kernel = g.tp <= 256
      ? (qk_only ? encoder_attention_s8_kernel<256, true> : encoder_attention_s8_kernel<256, false>)
      : (qk_only ? encoder_attention_s8_kernel<MAX_TOKENS, true>
                 : encoder_attention_s8_kernel<MAX_TOKENS, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<frames * heads, g.warps * 32, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<float*>(out), tokens, heads, coef_qk);
  return static_cast<int>(cudaGetLastError());
}
