// Encoder self-attention on q, k and v given as three base pointers with one
// shared row pitch: a staged kernel (one block per (frame, head)) up to 320
// tokens and a streamed one (one block per 64 query rows) above.
//
// Replaces: dfd_clip_tpu/ops/pallas_attention.py fused_encoder_attention_qkv
// (_make_encoder_qkv_kernel, packed [q | k | v] rows: the packed entry) and
// fused_encoder_attention (_make_encoder_kernel, separate q, k, v: the
// separate entry), and the attention stage of _make_attn_block_kernel and
// _make_full_block_kernel (the packed entry, through ops/encoder_block.py).
// All compute softmax(q k^T d^-1/2) v per (frame, head) with f32 logits.
//
// Bound on an H100: at CLIP ViT-B/16 (197 tokens, head_dim 64) the whole
// (frame, head) problem is 2 x 197^2 x 64 x 2 FLOP on 3 x 197 x 64 x 2 bytes
// read, ~130 FLOP per byte (ViT-L/14's 257 tokens: ~170): below the tensor
// cores' ~295, so device memory bounds it, and only if each byte is read once.
//
// Design: K and V of the (frame, head) are staged once in shared memory
// (2 x tp x 72 bf16 with row padding, tp the tokens rounded up to 16: 60 KB
// at 197 tokens, 78 KB at 257; dynamic shared memory above the 48 KB
// default). Each warp then walks 16-query-row tiles: S = Q K^T via
// nvcuda::wmma into an f32 row buffer (16 x tp), a softmax with the row
// maximum subtracted (f32, the XLA composition's normalised probabilities),
// the probabilities written back as bf16 over the rows of S already consumed,
// and O = P V with f32 accumulate. Keys past the real rows are zero in shared
// memory and get probability 0. Up to 8 warps share a block, fewer where
// their logits buffers would not fit the 227 KB a block may use (6 at 257
// tokens: 192 KB, one block per SM). Tokens are capped at MAX_TOKENS = 320
// (tp 320, 6 warps, 224 KB); the softmax's per-lane registers are sized at
// compile time, for 256 padded tokens (ViT-B's 197) or for 320, so the
// narrow towers keep the smaller instantiation.
//
// Above 320 tokens (CLIP ViT-L/14@336px: 577) the launcher takes the
// streamed kernel instead, a flash-attention schedule whose block body
// lives in csrc/attention_stream_tile.cuh. One block is 64 query rows of a
// (frame, head), 4 warps of 16 rows; K and V stream through shared memory
// in blocks of 64 keys, double-buffered with cp.async (46 KB a block, four
// blocks a SM). Each key block takes S = Q K^T on mma.sync m16n8k16 (bf16,
// f32 accumulate, Q's fragments kept in registers), then an online softmax
// in f32 registers: the logits times d^-1/2, a running maximum and sum, and
// the O accumulators rescaled by exp(m_old - m_new). P = exp(l - m) is cast
// to bf16 unnormalised and multiplied into V (the S fragments are the PV
// A fragments as they are); O is multiplied by 1 / sum once, at the end:
// the Pallas kernel's own rounding point (it rounds the unnormalised exp
// and multiplies by 1 / sum after PV), with the maximum subtracted. At 577
// tokens the problem is ~290 FLOP a byte read, near the tensor cores'
// ~295: bytes and operations bound it alike (~0.45 ms at (320, 577, 16 x
// 64)). Each query block reads its (frame, head)'s K and V once; the blocks
// of one (frame, head) are neighbours in the grid, so the ceil(tokens / 64)
// re-reads are meant to hit L2. The token count is capped only by the
// grid, frames x heads x ceil(tokens / 64) blocks. At 320 tokens and below
// the staged kernel runs, so the 197- and 257-token paths keep their
// results. The staged kernel does not carry over the TPU kernel's exp clamp
// at 60 or its deferred normalisation, the streamed one only the clamp:
// they differ from the TPU softmax only where a logit exceeds 60. The output
// is (frames x tokens, heads x 64), bf16, or f32 for the int8 whole block
// (_make_full_block_kernel), whose out-projection quantises the f32
// attention output per row; no block here sees a whole row, so that
// quantisation is csrc/quant_rows.cu's. The block body lives in
// csrc/attention_tile.cuh, shared with csrc/encoder_tower.cu.
#include "attention_stream_tile.cuh"
#include "attention_tile.cuh"

namespace {

using namespace attn_bf16;

template <int MAX_TP, bool OUT_F32>
__global__ void encoder_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, int ld,
                                         void* __restrict__ out, int tokens, int heads,
                                         float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  tile<MAX_TP, OUT_F32>(q, k, v, ld, out, tokens, heads, scale, blockIdx.x / heads,
                        blockIdx.x % heads, smem);
}

template <bool OUT_F32>
__global__ void __launch_bounds__(attn_stream::THREADS)
encoder_attention_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, int ld, void* __restrict__ out,
                                int tokens, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int groups = (tokens + attn_stream::BQ - 1) / attn_stream::BQ;
  const int fh = blockIdx.x / groups;
  attn_stream::tile<OUT_F32>(q, k, v, ld, out, tokens, heads, scale, fh / heads, fh % heads,
                             (blockIdx.x % groups) * attn_stream::BQ, smem);
}

int launch_stream(const void* q, const void* k, const void* v, long long ld, void* out,
                  int frames, int tokens, int heads, float scale, int out_f32, void* stream) {
  const long long blocks =
      (long long)frames * heads * ((tokens + attn_stream::BQ - 1) / attn_stream::BQ);
  if (blocks < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = out_f32 ? encoder_attention_stream_kernel<true>
                        : encoder_attention_stream_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), attn_stream::THREADS, attn_stream::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<int>(ld), out, tokens, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, long long ld, void* out, int frames,
           int tokens, int heads, float scale, int out_f32, void* stream) {
  if (tokens > MAX_TOKENS)
    return launch_stream(q, k, v, ld, out, frames, tokens, heads, scale, out_f32, stream);
  if (tokens < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(tokens);
  auto kernel = g.tp <= 256
      ? (out_f32 ? encoder_attention_kernel<256, true> : encoder_attention_kernel<256, false>)
      : (out_f32 ? encoder_attention_kernel<MAX_TOKENS, true>
                 : encoder_attention_kernel<MAX_TOKENS, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<frames * heads, g.warps * 32, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<int>(ld), out, tokens, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The separate entry: out[frames * tokens, heads * 64] (f32 when out_f32,
// else bf16) = attention over bf16 q, k and v whose row r of frame f starts
// at x + (f * tokens + r) * ld, heads x 64 values each. The three may be
// column blocks of one packed buffer (ld = 3 x heads x 64) or contiguous
// tensors (ld = heads x 64). 16-byte aligned rows (the wrapper checks);
// above 320 tokens the streamed kernel runs.
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
