// The attention study kernels: softmax(q k^T d^-1/2) v per (frame, head) on
// separate bf16 q, k, v (N, T, H, 64), in four numerics modes, -> (N, T, H,
// 64) bf16.
//
// Replaces: tools/bench_attention.py's Pallas variants, each mode with its
// original's rounding points:
//   kF32        _frames_grid_call over make_multiframe_kernel (and with
//               t_pad, pallas_pad256) and make_batched_dot_kernel, and
//               pair_packed (make_pair_packed_kernel): f32 Q, K and V, q
//               scaled before the dot, f32 logits, softmax normalised in f32
//               (p / sum), f32 PV, rounded to bf16 once;
//   kBf16       make_bf16_kernel and full_packed (make_full_packed_kernel):
//               bf16 operands, f32 logits times the scale after the dot,
//               the normalised P rounded to bf16 before PV, f32 accumulate;
//   kDiet       make_diet_kernel(with_max=True): exp(l - max) rounded to bf16
//               and multiplied by V, then divided by the f32 sum of the
//               unrounded p;
//   kDietNoMax  the same with exp(l) (with_max=False).
// The TPU scheduling devices are not carried over: frames per grid step, the
// 256-token pad (the pad keys are masked there, so the function is the
// unpadded one), and the head-pair block-diagonal K (and V) that fill the
// MXU's 128 lanes (the zero blocks add nothing: pair_packed and full_packed
// compute their modes' function).
//
// Bound on an H100 at the tool's (320, 197, 12 x 64): bytes in the bf16
// modes, 3 inputs and one output of 97 MB each at 3.35 TB/s (0.116 ms);
// kF32 runs its 38.1 GFLOP on the f32 units (67 TFLOP/s: 0.57 ms), since
// the CPU's interpret mode computes them exactly in f32 and TF32 would not.
//
// Design: the staged schedule of csrc/attention_tile.cuh (one block per
// (frame, head), K and V staged whole in shared memory, each warp a 16-row
// query tile through an f32 logits buffer), with the mode a template
// parameter. kF32 computes both products with FFMA: a lane owns 8 keys (S =
// Q K^T, 8 rows x 8 keys of accumulators at a time against q rows read as
// broadcasts) and then 2 output dims (PV over 4 keys a step); its K and V
// rows are staged at a pitch of 33 words, so a lane per key reads without
// bank conflicts. The bf16 modes take both products on the tensor cores
// (nvcuda::wmma, f32 accumulate), writing bf16 P over the consumed logits.
// Tokens are capped at MAX_TOKENS = 256 (the tool's 197, padded to 208).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int D = 64;
constexpr int MAX_TOKENS = 256;
constexpr int WARPS = 8;
constexpr size_t SMEM_LIMIT = 232448;

enum Mode : int { kF32 = 0, kBf16 = 1, kDiet = 2, kDietNoMax = 3 };

struct Geometry {
  int tp;        // tokens rounded up to 16
  int ldk;       // bf16 pitch of the staged K and V rows
  int ldp;       // bf16 pitch of the P rows (tensor-core modes)
  int q_bytes;   // per-warp Q tile: f32 scaled q (kF32) or bf16 q
  int s_bytes;   // per-warp f32 logits (also P, and O staging)
  int warps;
  size_t kv_bytes, smem;
};

__host__ __device__ inline int round128(int x) { return (x + 127) / 128 * 128; }

__host__ __device__ inline Geometry geometry(int tokens, int mode) {
  Geometry g;
  g.tp = (tokens + 15) / 16 * 16;
  g.ldk = mode == kF32 ? D + 2 : D + 8;
  g.ldp = g.tp + 8;
  g.q_bytes = round128(mode == kF32 ? 16 * D * 4 : 16 * (D + 8) * 2);
  int s = 16 * g.tp * 4;
  const int need = 16 * g.ldp * 2 + 16 * D * 4;
  if (mode != kF32 && need > s) s = need;
  g.s_bytes = round128(s);
  g.kv_bytes = round128(2 * g.tp * g.ldk * 2);
  const size_t per = g.q_bytes + g.s_bytes + 128;   // + the 16 row factors
  g.warps = WARPS;
  while (g.warps > 1 && g.kv_bytes + g.warps * per > SMEM_LIMIT) --g.warps;
  g.smem = g.kv_bytes + g.warps * per;
  return g;
}

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32)
study_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out, int tokens, int heads,
                       float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geometry g = geometry(tokens, MODE);
  const int frame = blockIdx.x / heads, head = blockIdx.x % heads;
  const int width = heads * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)frame * tokens * width + head * D;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + g.tp * g.ldk;

  if (MODE == kF32) {   // 33-word rows: plain 4-byte copies
    unsigned* K32 = reinterpret_cast<unsigned*>(Ks);
    unsigned* V32 = reinterpret_cast<unsigned*>(Vs);
    for (int c = threadIdx.x; c < g.tp * (D / 2); c += blockDim.x) {
      const int r = c / (D / 2), w = c % (D / 2);
      unsigned kw = 0u, vw = 0u;
      if (r < tokens) {
        kw = reinterpret_cast<const unsigned*>(k + base + (size_t)r * width)[w];
        vw = reinterpret_cast<const unsigned*>(v + base + (size_t)r * width)[w];
      }
      K32[r * (g.ldk / 2) + w] = kw;
      V32[r * (g.ldk / 2) + w] = vw;
    }
  } else {
    for (int c = threadIdx.x; c < g.tp * (D / 8); c += blockDim.x) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      const bool ok = r < tokens;
      const size_t at = base + (size_t)(ok ? r : 0) * width + cc;
      cp_async16(&Ks[r * g.ldk + cc], k + at, ok);
      cp_async16(&Vs[r * g.ldk + cc], v + at, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  unsigned char* wbase =
      smem + g.kv_bytes + (size_t)warp * (g.q_bytes + g.s_bytes + 128);
  float* S = reinterpret_cast<float*>(wbase + g.q_bytes);
  float* rowf = reinterpret_cast<float*>(wbase + g.q_bytes + g.s_bytes);
  const int tiles = g.tp / 16;
  const int per_lane = (g.tp + 31) / 32;

  for (int tile = warp; warp < g.warps && tile < tiles; tile += g.warps) {
    const int q0 = tile * 16;
    if (MODE == kF32) {
      // q * scale in f32, 16 x 64
      float* Qf = reinterpret_cast<float*>(wbase);
      for (int c = lane; c < 16 * (D / 2); c += 32) {
        const int r = c / (D / 2), w = c % (D / 2);
        float2 x = make_float2(0.f, 0.f);
        if (q0 + r < tokens)
          x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
              q + base + (size_t)(q0 + r) * width)[w]);
        Qf[r * D + 2 * w] = x.x * scale;
        Qf[r * D + 2 * w + 1] = x.y * scale;
      }
      __syncwarp();
      // S = (q * scale) K^T: keys lane + 32 i, rows in two halves of 8
      const unsigned* K32 = reinterpret_cast<const unsigned*>(Ks);
      for (int half = 0; half < 2; ++half) {
        float acc[8][MAX_TOKENS / 32];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int i = 0; i < MAX_TOKENS / 32; ++i) acc[r][i] = 0.f;
        for (int d2 = 0; d2 < D / 2; ++d2) {
          float2 kf[MAX_TOKENS / 32];
#pragma unroll
          for (int i = 0; i < MAX_TOKENS / 32; ++i) {
            const int c = lane + 32 * i;
            kf[i] = make_float2(0.f, 0.f);
            if (i < per_lane && c < g.tp) {
              unsigned w = K32[c * (g.ldk / 2) + d2];
              kf[i] = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float2 qq = *reinterpret_cast<const float2*>(&Qf[(half * 8 + r) * D + 2 * d2]);
#pragma unroll
            for (int i = 0; i < MAX_TOKENS / 32; ++i)
              acc[r][i] = fmaf(qq.y, kf[i].y, fmaf(qq.x, kf[i].x, acc[r][i]));
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int i = 0; i < MAX_TOKENS / 32; ++i) {
            const int c = lane + 32 * i;
            if (i < per_lane && c < g.tp) S[(half * 8 + r) * g.tp + c] = acc[r][i];
          }
      }
      __syncwarp();
    } else {
      bf16* Qs = reinterpret_cast<bf16*>(wbase);
      for (int c = lane; c < 16 * (D / 8); c += 32) {
        const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
        const bool ok = q0 + r < tokens;
        cp_async16(&Qs[r * (D + 8) + cc], q + base + (size_t)(ok ? q0 + r : 0) * width + cc, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wmma::load_matrix_sync(qa[kk], &Qs[kk * 16], D + 8);
      for (int n = 0; n < tiles; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
        wmma::fill_fragment(sc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, &Ks[n * 16 * g.ldk + kk * 16], g.ldk);
          wmma::mma_sync(sc, qa[kk], kf, sc);
        }
        wmma::store_matrix_sync(&S[n * 16], sc, g.tp, wmma::mem_row_major);
      }
      __syncwarp();
    }

    // Row softmax in f32 (keys past `tokens` get p = 0). kF32 writes the
    // normalised f32 P over S; the other modes write bf16 P at pitch ldp,
    // whose row r lies inside the bytes of S rows <= r, already read.
    bf16* P = reinterpret_cast<bf16*>(S);
    for (int r = 0; r < 16; ++r) {
      float x[MAX_TOKENS / 32];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < MAX_TOKENS / 32; ++i) {
        const int c = lane + 32 * i;
        const bool ok = i < per_lane && c < tokens;
        x[i] = ok ? (MODE == kF32 ? S[r * g.tp + c] : S[r * g.tp + c] * scale) : -INFINITY;
        m = fmaxf(m, x[i]);
      }
      if (MODE != kDietNoMax) m = warp_max(m);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_TOKENS / 32; ++i) {
        x[i] = x[i] == -INFINITY ? 0.f : expf(MODE == kDietNoMax ? x[i] : x[i] - m);
        s += x[i];
      }
      s = warp_sum(s);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < MAX_TOKENS / 32; ++i) {
        const int c = lane + 32 * i;
        if (i < per_lane && c < g.tp) {
          if (MODE == kF32) S[r * g.tp + c] = x[i] / s;
          else if (MODE == kBf16) P[r * g.ldp + c] = __float2bfloat16(x[i] / s);
          else P[r * g.ldp + c] = __float2bfloat16(x[i]);
        }
      }
      if (lane == 0) rowf[r] = s;
    }
    __syncwarp();

    if (MODE == kF32) {
      // O = P V: this lane's dims 2 lane, 2 lane + 1 of the 16 rows, 4 keys
      // a step (pad keys have P = 0 and V = 0)
      const unsigned* V32 = reinterpret_cast<const unsigned*>(Vs);
      float o[16][2];
#pragma unroll
      for (int r = 0; r < 16; ++r) o[r][0] = o[r][1] = 0.f;
      for (int c = 0; c < g.tp; c += 4) {
        float2 vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          unsigned w = V32[(c + e) * (g.ldk / 2) + lane];
          vv[e] = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(&S[r * g.tp + c]);
          o[r][0] = fmaf(p.w, vv[3].x, fmaf(p.z, vv[2].x, fmaf(p.y, vv[1].x, fmaf(p.x, vv[0].x, o[r][0]))));
          o[r][1] = fmaf(p.w, vv[3].y, fmaf(p.z, vv[2].y, fmaf(p.y, vv[1].y, fmaf(p.x, vv[0].y, o[r][1]))));
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (q0 + r < tokens)
          reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)(q0 + r) * width)[lane] =
              __floats2bfloat162_rn(o[r][0], o[r][1]);
    } else {
      // O = P V on the tensor cores, staged after the P rows
      float* O = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(S) + 16 * g.ldp * 2);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(oc[j], 0.0f);
      for (int kt = 0; kt < tiles; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::load_matrix_sync(pa, &P[kt * 16], g.ldp);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, &Vs[kt * 16 * g.ldk + j * 16], g.ldk);
          wmma::mma_sync(oc[j], pa, vf, oc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        wmma::store_matrix_sync(&O[j * 16], oc[j], D, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 32;
      if (q0 + r < tokens) {
        const bool diet = MODE == kDiet || MODE == kDietNoMax;
        const float den = rowf[r];
        bf16* dst = out + base + (size_t)(q0 + r) * width + c0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Pack8 pk;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float o = O[r * D + c0 + e * 8 + i];
            pk.h[i] = __float2bfloat16(diet ? o / den : o);
          }
          *reinterpret_cast<uint4*>(dst + e * 8) = pk.u;
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// out[N, T, H, 64] bf16 = attention over contiguous bf16 q, k, v [N, T, H,
// 64] in numerics mode `mode` (kF32, kBf16, kDiet, kDietNoMax), 1 to 256
// tokens.
extern "C" int dfd_study_attention(const void* q, const void* k, const void* v, void* out,
                                   int frames, int tokens, int heads, float scale, int mode,
                                   void* stream) {
  if (tokens < 1 || tokens > MAX_TOKENS || mode < kF32 || mode > kDietNoMax || frames < 1 ||
      heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(tokens, mode);
  auto kernel = mode == kF32     ? study_attention_kernel<kF32>
                : mode == kBf16  ? study_attention_kernel<kBf16>
                : mode == kDiet  ? study_attention_kernel<kDiet>
                                 : study_attention_kernel<kDietNoMax>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<frames * heads, g.warps * 32, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), tokens, heads, scale);
  return static_cast<int>(cudaGetLastError());
}
