// Encoder self-attention, one block per (frame, head), on q, k and v given as
// three base pointers with one shared row pitch.
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
// narrow towers keep the smaller instantiation. ViT-L/14@336px's 577 tokens
// need the K/V stream tiled, which this kernel does not do. The TPU
// kernel's exp clamp at 60 and deferred normalisation are not carried over:
// they differ from this softmax only where a logit exceeds 60. The output
// is (frames x tokens, heads x 64), bf16, or f32 for the int8 whole block
// (_make_full_block_kernel), whose out-projection quantises the f32
// attention output per row; no block here sees a whole row, so that
// quantisation is csrc/quant_rows.cu's.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 64;
constexpr int LDK = D + 8;        // shared-memory row pitch (bf16) of Q, K, V
constexpr int MAX_TOKENS = 320;   // largest token count handled (a multiple of 16)
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may use

struct Geometry {
  int tp;        // tokens rounded up to 16
  int ldp;       // bf16 pitch of the probability rows
  int s_bytes;   // per-warp f32 logits buffer (also holds P and O staging)
  int warps;
  size_t smem;
};

__host__ __device__ inline Geometry geometry(int tokens) {
  Geometry g;
  g.tp = (tokens + 15) / 16 * 16;
  g.ldp = g.tp + 8;
  int s = 16 * g.tp * 4;
  int need = 16 * g.ldp * 2 + 16 * D * 4;   // P rows, then O staging
  g.s_bytes = ((s > need ? s : need) + 31) / 32 * 32;
  int tiles = g.tp / 16;
  int per_warp = (tiles + 7) / 8;
  g.warps = (tiles + per_warp - 1) / per_warp;
  const size_t kv = (size_t)2 * g.tp * LDK * 2, per = 16 * LDK * 2 + g.s_bytes;
  while (g.warps > 1 && kv + g.warps * per > SMEM_LIMIT) --g.warps;
  g.smem = kv + g.warps * per;
  return g;
}

// Row r of frame f, head h of x lies at x + (f * tokens + r) * ld + h * 64;
// tokens padded to 16 are at most MAX_TP.
template <int MAX_TP, bool OUT_F32>
__global__ void encoder_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                         const bf16* __restrict__ v, int ld,
                                         void* __restrict__ out, int tokens, int heads,
                                         float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g = geometry(tokens);
  const int frame = blockIdx.x / heads, head = blockIdx.x % heads;
  const int width = heads * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)frame * tokens * ld + head * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + g.tp * LDK;
  unsigned char* wbase = smem + (size_t)2 * g.tp * LDK * 2 + (size_t)warp * (16 * LDK * 2 + g.s_bytes);
  bf16* Qs = reinterpret_cast<bf16*>(wbase);
  float* S = reinterpret_cast<float*>(wbase + 16 * LDK * 2);
  bf16* P = reinterpret_cast<bf16*>(S);
  float* O = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(S) + 16 * g.ldp * 2);

  for (int c = threadIdx.x; c < g.tp * 8; c += blockDim.x) {
    const int r = c / 8, cc = (c % 8) * 8;
    const bool ok = r < tokens;
    const size_t at = (size_t)(ok ? r : 0) * ld + cc;
    cp_async16(&Ks[r * LDK + cc], kb + at, ok);
    cp_async16(&Vs[r * LDK + cc], vb + at, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int tiles = g.tp / 16;
  const int per_lane = (g.tp + 31) / 32;
  for (int tile = warp; tile < tiles; tile += g.warps) {
    const int q0 = tile * 16;
    for (int c = lane; c < 16 * 8; c += 32) {
      const int r = c / 8, cc = (c % 8) * 8;
      const bool ok = q0 + r < tokens;
      cp_async16(&Qs[r * LDK + cc], qb + (size_t)(ok ? q0 + r : 0) * ld + cc, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // S = Q K^T (16 x tp, f32)
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qa[kk], &Qs[kk * 16], LDK);
    for (int n = 0; n < tiles; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, &Ks[n * 16 * LDK + kk * 16], LDK);
        wmma::mma_sync(sc, qa[kk], kf, sc);
      }
      wmma::store_matrix_sync(&S[n * 16], sc, g.tp, wmma::mem_row_major);
    }
    __syncwarp();

    // Row softmax. P row r (bf16, pitch ldp <= 2 tp) lies inside the bytes
    // of S rows <= r, which this warp has already read into registers.
    for (int r = 0; r < 16; ++r) {
      float x[MAX_TP / 32];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        const int c = lane + 32 * i;
        x[i] = (i < per_lane && c < tokens) ? S[r * g.tp + c] * scale : -INFINITY;
        m = fmaxf(m, x[i]);
      }
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        x[i] = (x[i] == -INFINITY) ? 0.f : expf(x[i] - m);
        s += x[i];
      }
      const float inv = 1.0f / warp_sum(s);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        const int c = lane + 32 * i;
        if (i < per_lane && c < g.tp) P[r * g.ldp + c] = __float2bfloat16(x[i] * inv);
      }
    }
    __syncwarp();

    // O = P V (16 x 64, f32)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oc[j], 0.0f);
    for (int kt = 0; kt < tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, &P[kt * 16], g.ldp);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, &Vs[kt * 16 * LDK + j * 16], LDK);
        wmma::mma_sync(oc[j], pa, vf, oc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(&O[j * 16], oc[j], D, wmma::mem_row_major);
    __syncwarp();

    const int r = lane / 2, c0 = (lane % 2) * 32;
    if (q0 + r < tokens) {
      const size_t at = ((size_t)frame * tokens + q0 + r) * width + head * D + c0;
      if (OUT_F32) {
        float* dst = static_cast<float*>(out) + at;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          *reinterpret_cast<float4*>(dst + e * 4) =
              *reinterpret_cast<const float4*>(&O[r * D + c0 + e * 4]);
      } else {
        bf16* dst = static_cast<bf16*>(out) + at;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Pack8 p;
#pragma unroll
          for (int i = 0; i < 8; ++i) p.h[i] = __float2bfloat16(O[r * D + c0 + e * 8 + i]);
          *reinterpret_cast<uint4*>(dst + e * 8) = p.u;
        }
      }
    }
    __syncwarp();
  }
}

int launch(const void* q, const void* k, const void* v, long long ld, void* out, int frames,
           int tokens, int heads, float scale, int out_f32, void* stream) {
  if (tokens < 1 || tokens > MAX_TOKENS) return static_cast<int>(cudaErrorInvalidValue);
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
// tensors (ld = heads x 64). tokens <= 320, 16-byte aligned rows (the
// wrapper checks).
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
