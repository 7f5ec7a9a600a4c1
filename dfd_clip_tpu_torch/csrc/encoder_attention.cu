// Encoder self-attention over the packed qkv projection, one block per
// (frame, head).
//
// Replaces: the attention stage of dfd_clip_tpu/ops/pallas_attention.py
// _make_attn_block_kernel (logits -> softmax -> PV for all heads of a frame
// out of the packed [q | k | v] rows).
//
// Bound on an H100: at CLIP ViT-B/16 (197 tokens, head_dim 64) the whole
// (frame, head) problem is 2 x 197^2 x 64 x 2 FLOP on 3 x 197 x 64 x 2 bytes
// read, ~130 FLOP per byte: below the tensor cores' ~295, so device memory
// bounds it, and only if each byte is read once.
//
// Design: K and V of the (frame, head) are staged once in shared memory
// (2 x 208 x 72 bf16 with row padding, ~60 KB: dynamic shared memory above
// the 48 KB default). Each warp then walks 16-query-row tiles: S = Q K^T via
// nvcuda::wmma into an f32 row buffer, a softmax with the row maximum
// subtracted (f32, the XLA composition's normalised probabilities), the
// probabilities written back as bf16 over the rows of S already consumed, and
// O = P V with f32 accumulate. Keys past the 197 real rows are zero in
// shared memory and get probability 0. The TPU kernel's exp clamp at 60 and
// deferred normalisation are not carried over: they differ from this softmax
// only where a logit exceeds 60. The output is bf16, or f32 for the int8
// whole block (_make_full_block_kernel), whose out-projection quantises the
// f32 attention output `attn32` per row; no block here sees a whole row, so
// that quantisation is csrc/quant_rows.cu's.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 64;
constexpr int LDK = D + 8;       // shared-memory row pitch (bf16) of Q, K, V
constexpr int MAX_TP = 256;      // largest padded token count handled

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
  g.smem = (size_t)2 * g.tp * LDK * 2 + (size_t)g.warps * (16 * LDK * 2 + g.s_bytes);
  return g;
}

template <bool OUT_F32>
__global__ void encoder_attention_kernel(const bf16* __restrict__ qkv, void* __restrict__ out,
                                         int tokens, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g = geometry(tokens);
  const int frame = blockIdx.x / heads, head = blockIdx.x % heads;
  const int width = heads * D, ld = 3 * width;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* base = qkv + (size_t)frame * tokens * ld;

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
    const bf16* row = base + (size_t)(ok ? r : 0) * ld + head * D + cc;
    cp_async16(&Ks[r * LDK + cc], row + width, ok);
    cp_async16(&Vs[r * LDK + cc], row + 2 * width, ok);
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
      cp_async16(&Qs[r * LDK + cc], base + (size_t)(ok ? q0 + r : 0) * ld + head * D + cc, ok);
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
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, &Ks[n * 16 * LDK + kk * 16], LDK);
        wmma::mma_sync(sc, qa[kk], kb, sc);
      }
      wmma::store_matrix_sync(&S[n * 16], sc, g.tp, wmma::mem_row_major);
    }
    __syncwarp();

    // Row softmax. P row r (bf16, pitch ldp <= 2 tp) lies inside the bytes
    // of S rows <= r, which this warp has already read into registers.
    for (int r = 0; r < 16; ++r) {
      float v[MAX_TP / 32];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        const int c = lane + 32 * i;
        v[i] = (i < per_lane && c < tokens) ? S[r * g.tp + c] * scale : -INFINITY;
        m = fmaxf(m, v[i]);
      }
      m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        v[i] = (v[i] == -INFINITY) ? 0.f : expf(v[i] - m);
        s += v[i];
      }
      const float inv = 1.0f / warp_sum(s);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < MAX_TP / 32; ++i) {
        const int c = lane + 32 * i;
        if (i < per_lane && c < g.tp) P[r * g.ldp + c] = __float2bfloat16(v[i] * inv);
      }
    }
    __syncwarp();

    // O = P V (16 x 64, f32)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oc[j], 0.0f);
    for (int k = 0; k < tiles; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, &P[k * 16], g.ldp);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, &Vs[k * 16 * LDK + j * 16], LDK);
        wmma::mma_sync(oc[j], pa, vb, oc[j]);
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
        for (int k = 0; k < 8; ++k)
          *reinterpret_cast<float4*>(dst + k * 4) =
              *reinterpret_cast<const float4*>(&O[r * D + c0 + k * 4]);
      } else {
        bf16* dst = static_cast<bf16*>(out) + at;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          Pack8 p;
#pragma unroll
          for (int e = 0; e < 8; ++e) p.h[e] = __float2bfloat16(O[r * D + c0 + k * 8 + e]);
          *reinterpret_cast<uint4*>(dst + k * 8) = p.u;
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// out[frames * tokens, heads * 64] (f32 when out_f32, else bf16) = attention
// over qkv[frames * tokens, 3 * heads * 64]. head_dim must be 64 and tokens
// <= 256 (the wrapper checks).
extern "C" int dfd_encoder_attention(const void* qkv, void* out, int frames, int tokens,
                                     int heads, float scale, int out_f32, void* stream) {
  const Geometry g = geometry(tokens);
  auto kernel = out_f32 ? encoder_attention_kernel<true> : encoder_attention_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<frames * heads, g.warps * 32, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), out, tokens, heads, scale);
  return static_cast<int>(cudaGetLastError());
}
