// The attention study kernels: softmax(q k^T d^-1/2) v per (frame, head) on
// separate bf16 q, k, v (N, T, H, 64), in four numerics modes, -> (N, T, H,
// 64) bf16, 1 to 256 tokens.
//
// Replaces: tools/bench_attention.py's Pallas variants, each mode with its
// original's rounding points:
//   kF32        _frames_grid_call over make_multiframe_kernel (and with
//               t_pad, pallas_pad256) and make_batched_dot_kernel, and
//               pair_packed (make_pair_packed_kernel): f32 Q, K and V, q
//               scaled before the dot, f32 logits, softmax normalised in f32,
//               f32 PV, rounded to bf16 once;
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
// Design, the bf16 modes: the encoder attention's frame (csrc/attention_hopper.cuh,
// csrc/encoder_attention.cu's header): a persistent grid of one block a SM
// over the (frame, head) items, a producer warpgroup moving Q and the K/V
// key blocks by TMA (3-D tensor maps, 64 x 64 boxes in the 128-byte
// swizzle) into the mbarrier ring, two consumer warpgroups on wgmma. At
// <= 256 tokens an item's key blocks (NKB <= 4, a template parameter) stay
// resident in the ring, and the consumer (hattn::consume_rows, the rounding
// point a template parameter) keeps a query tile's S for all of them in
// registers (up to 128 f32 a thread, hence two consumers of 232 registers):
// one group of products for S, the rows' exact maxima and sums, P at the
// mode's own point rounded to bf16, one group of products for P V. No online
// rescaling moves a rounding point, and S is computed once. Where the last
// key block holds <= 16 real keys (197 tokens) it takes m64n16 products and
// one k16 step of P V (the encoder attention's narrow tail).
//
// Design, kF32: exact f32 products on the f32 units, as a SIMT GEMM. A block
// of one warp a band of 32 query rows (ceil(T / 32) warps) walks the items
// of a persistent grid, two blocks a SM (so one block's loads and barriers
// run under the other's products). An item's Q times d^-1/2 is converted
// once into f32 in shared memory, transposed ([dim][row], at a pitch of T
// rounded up to 4), and its keys go in chunks (ops/_cuda.py study_geometry
// sizes them so that two blocks fit): a chunk's K^T ([dim][key]) and V
// ([key][dim], at a pitch of 68 floats) in f32, while the TMA unit
// prefetches the block's next item into L2 (cp.async.bulk.prefetch.tensor).
// A warp walks a chunk's keys in tiles of 32: each lane holds a 4 x 8 tile
// of S (4 rows, 8 keys; its operands a 16-byte vector of Q and two of K a
// dim), the rows' online softmax in f32 (maxima by quad shuffles, O
// rescaled; every value stays f32, so no rounding point moves), then O +=
// P V with each lane a 4 x 16 tile of O (4 rows, 16 dims in four runs of 4,
// so that no two lanes of a quarter-warp load from one bank), P fetched by
// shuffle from the lane that holds it and V as four 16-byte vectors a key.
// Rows and keys past T are computed (a tile is 32 wide) but masked or never
// stored.
#include "attention_hopper.cuh"

namespace {

constexpr int D = 64;
constexpr int MAX_TOKENS = 256;

enum Mode : int { kF32 = 0, kBf16 = 1, kDiet = 2, kDietNoMax = 3 };
static_assert(int(kBf16) == int(hattn::kNormP) && int(kDiet) == int(hattn::kDiet) &&
                  int(kDietNoMax) == int(hattn::kDietNoMax),
              "the bf16 modes are the consumer's rounding points");

// ---- the bf16 modes: TMA / wgmma ----------------------------------------------------------
constexpr int NCONS = 2;
constexpr int THREADS = 128 * (NCONS + 1);
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(LAUNCH_REGS - PRODUCER_REGS >= NCONS * (CONSUMER_REGS - LAUNCH_REGS),
              "setmaxnreg would wait for registers that are never freed");
constexpr int SMEM_TC = hattn::Layout<NCONS>::DATA_BYTES + hattn::Layout<NCONS>::BAR_BYTES + 1024;

template <int MODE, int NKB, bool NARROW>
__global__ void __launch_bounds__(THREADS, 1)
study_attention_tc(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
                   const hattn::Geometry g, float coef) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const hattn::Smem<NCONS> sm{base, base + hattn::Layout<NCONS>::DATA_BYTES};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) sm.init(g);
  __syncthreads();
  const hattn::Counts<NCONS> cnt{};
  if (warp < 4) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0)
      hattn::produce_kv(sm, g, &map_k, &map_v, cnt);
    else if (warp == 1 && lane == 0)
      hattn::produce_q(sm, g, &map_q, cnt);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    hattn::consume_rows_as<NCONS, MODE, NKB, NARROW>(warp / 4 - 1, sm, g, coef, out, cnt);
  }
}

template <int MODE, int NKB, bool NARROW>
int launch_tc(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out,
              const hattn::Geometry& g, float coef, int sms, cudaStream_t stream) {
  auto kernel = study_attention_tc<MODE, NKB, NARROW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_TC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = g.items < sms ? g.items : sms;
  kernel<<<grid, THREADS, SMEM_TC, stream>>>(mq, mk, mv, static_cast<bf16*>(out), g, coef);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_tc(const void* q, const void* k, const void* v, void* out, int frames, int tokens,
              int heads, float scale, int sms, cudaStream_t stream) {
  alignas(64) CUtensorMap mq, mk, mv;
  const long long ld = (long long)heads * D;
  if (!hattn::encode(&mq, q, ld, frames, tokens, heads) ||
      !hattn::encode(&mk, k, ld, frames, tokens, heads) ||
      !hattn::encode(&mv, v, ld, frames, tokens, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  const hattn::Geometry g = hattn::geometry<NCONS>(frames, tokens, heads);
  const float coef = scale * hattn::LOG2E;
  const bool nr = hattn::narrow(tokens);
  switch (g.nkb) {
    case 1: return launch_tc<MODE, 1, false>(mq, mk, mv, out, g, coef, sms, stream);
    case 2:
      return nr ? launch_tc<MODE, 2, true>(mq, mk, mv, out, g, coef, sms, stream)
                : launch_tc<MODE, 2, false>(mq, mk, mv, out, g, coef, sms, stream);
    case 3:
      return nr ? launch_tc<MODE, 3, true>(mq, mk, mv, out, g, coef, sms, stream)
                : launch_tc<MODE, 3, false>(mq, mk, mv, out, g, coef, sms, stream);
    default:
      return nr ? launch_tc<MODE, 4, true>(mq, mk, mv, out, g, coef, sms, stream)
                : launch_tc<MODE, 4, false>(mq, mk, mv, out, g, coef, sms, stream);
  }
}

// ---- kF32: register-tiled FFMA ------------------------------------------------------------
constexpr int BAND = 32;                 // query rows a warp
constexpr int KTILE = 32;                // keys a tile
constexpr int MAX_BANDS = MAX_TOKENS / BAND;
constexpr int VP = D + 4;                // V's pitch in floats (16-byte rows, no bank conflicts)

struct F32Geo {
  int tokens, heads, items;
  int pitch;   // of Q^T: tokens rounded up to 4
  int chunk;   // keys a chunk (a multiple of KTILE), also K^T's pitch
};

// f32 shared memory: Q^T [64][pitch] and K^T [64][chunk] (each + 32 floats
// that the last band's or key tile's reads past the end may touch), V
// [chunk][VP].
__host__ __device__ inline int f32_floats(int pitch, int chunk) {
  return D * pitch + BAND + D * chunk + BAND + chunk * VP;
}

// Eight bf16 values (a 16-byte word, the first in the low half) as f32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int col, int row,
                                             int frame) {
  asm volatile("cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(col), "r"(row), "r"(frame)
               : "memory");
}

// O (4 rows x 16 dims a lane) += P V over one key tile: P of the tile's key
// 8 kq + e, row r, lives in s[r][e] of lane (rg, kq); vt: the tile's first V
// row; keys: its real keys (all 32 when FULL). A lane's 16 dims are 16 i +
// 4 dg + {0..3}, i = 0..3, so the 4 lanes of a quarter-warp read 64
// contiguous bytes a load (16 dg contiguous dims would put dg and dg + 2 on
// the same banks).
template <bool FULL>
__device__ __forceinline__ void pv_tile(float (&o)[4][16], const float (&s)[4][8],
                                        const float* __restrict__ vt, int keys, int rg, int dg) {
#pragma unroll
  for (int kq = 0; kq < 4; ++kq)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = kq * 8 + e;
      if (!FULL && key >= keys) continue;
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = __shfl_sync(0xffffffffu, s[r][e], rg * 4 + kq);
      const float* vr = vt + key * VP + 4 * dg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(vr + 16 * i);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[r][4 * i] = fmaf(p[r], x.x, o[r][4 * i]);
          o[r][4 * i + 1] = fmaf(p[r], x.y, o[r][4 * i + 1]);
          o[r][4 * i + 2] = fmaf(p[r], x.z, o[r][4 * i + 2]);
          o[r][4 * i + 3] = fmaf(p[r], x.w, o[r][4 * i + 3]);
        }
      }
    }
}

__global__ void __launch_bounds__(MAX_BANDS * 32, 2)
study_attention_f32(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ q,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    bf16* __restrict__ out, const F32Geo g, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int T = g.tokens, P = g.pitch, KC = g.chunk;
  float* qt = fsm;                        // Q^T x d^-1/2
  float* kt = qt + D * P + BAND;          // the chunk's K^T
  float* vs = kt + D * KC + BAND;         // the chunk's V
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 4, kg = lane % 4;   // a lane's 4 rows; its 8 keys (QK) / 16 dims (PV)
  const int width = g.heads * D;
  const int row0 = warp * BAND + rg * 4;
  auto prefetch = [&](int it) {
    tma_prefetch(&map_q, (it % g.heads) * D, 0, it / g.heads);
    tma_prefetch(&map_k, (it % g.heads) * D, 0, it / g.heads);
    tma_prefetch(&map_v, (it % g.heads) * D, 0, it / g.heads);
  };
  if (threadIdx.x == 0 && blockIdx.x < g.items) prefetch(blockIdx.x);
  for (int it = blockIdx.x; it < g.items; it += gridDim.x) {
    const int frame = it / g.heads, head = it % g.heads;
    const size_t item = (size_t)frame * T * width + head * D;
    float o[4][16], m[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) o[r][i] = 0.f;
    }
    for (int c0 = 0; c0 < T; c0 += KC) {
      const int nk = min(KC, T - c0);
      __syncthreads();   // every band is done with the buffers
      if (c0 == 0) {
        if (threadIdx.x == 0 && it + gridDim.x < g.items) prefetch(it + gridDim.x);
        // Q x d^-1/2 into f32, transposed: lanes over rows, 8 dims each
#pragma unroll 2
        for (int idx = threadIdx.x; idx < 8 * T; idx += blockDim.x) {
          const int c = idx / T, r = idx % T;
          float f[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(q + item + (size_t)r * width + c * 8)), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) qt[(c * 8 + e) * P + r] = f[e] * scale;
        }
      }
      // the chunk's K (transposed) and V into f32
#pragma unroll 2
      for (int idx = threadIdx.x; idx < 8 * nk; idx += blockDim.x) {
        const int c = idx / nk, r = idx % nk;
        const size_t at = item + (size_t)(c0 + r) * width + c * 8;
        float kf[8], vf[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(k + at)), kf);
        unpack8(__ldg(reinterpret_cast<const uint4*>(v + at)), vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) kt[(c * 8 + e) * KC + r] = kf[e];
        float4* vr = reinterpret_cast<float4*>(vs + r * VP + c * 8);
        vr[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
        vr[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
      }
      __syncthreads();

      // ---- this warp's band of 32 query rows against the chunk's keys
      for (int key0 = 0; key0 < nk; key0 += KTILE) {
        float s[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[r][e] = 0.f;
        const float* qp = qt + row0;
        const float* kp = kt + key0 + kg * 8;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float4 a = *reinterpret_cast<const float4*>(qp + d * P);
          const float4 b0 = *reinterpret_cast<const float4*>(kp + d * KC);
          const float4 b1 = *reinterpret_cast<const float4*>(kp + d * KC + 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 8; ++e) s[r][e] = fmaf(av[r], bv[e], s[r][e]);
        }
        const int keys = min(KTILE, nk - key0);
        if (keys < KTILE) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (kg * 8 + e >= keys)
#pragma unroll
              for (int r = 0; r < 4; ++r) s[r][e] = -INFINITY;
        }
        // online softmax in f32: the row's 32 keys lie on the lane's quad
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float mx = s[r][0];
#pragma unroll
          for (int e = 1; e < 8; ++e) mx = fmaxf(mx, s[r][e]);
          const float mnew = fmaxf(m[r], quad_max(mx));
          const float alpha = __expf(m[r] - mnew);   // 0 on the first tile
          m[r] = mnew;
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s[r][e] = __expf(s[r][e] - mnew);
            sum += s[r][e];
          }
          l[r] = l[r] * alpha + sum;
#pragma unroll
          for (int i = 0; i < 16; ++i) o[r][i] *= alpha;
        }
        if (keys == KTILE)
          pv_tile<true>(o, s, vs + key0 * VP, keys, rg, kg);
        else
          pv_tile<false>(o, s, vs + key0 * VP, keys, rg, kg);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float inv = 1.0f / quad_sum(l[r]);
      const int row = row0 + r;
      if (row >= T) continue;
      bf16* dst = out + item + (size_t)row * width + 4 * kg;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint2 w;
        w.x = pack_bf16(o[r][4 * i] * inv, o[r][4 * i + 1] * inv);
        w.y = pack_bf16(o[r][4 * i + 2] * inv, o[r][4 * i + 3] * inv);
        *reinterpret_cast<uint2*>(dst + 16 * i) = w;
      }
    }
  }
}

// (heads x 64 columns, tokens, frames) bf16, boxes of 64 x tokens x 1 (an
// item's rows, for the L2 prefetch).
bool encode_item(CUtensorMap* map, const void* x, int frames, int tokens, int heads) {
  hopper::EncodeTiled fn = hopper::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)tokens, (cuuint64_t)frames};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * D * 2, (cuuint64_t)heads * D * 2 * tokens};
  const cuuint32_t box[3] = {D, (cuuint32_t)tokens, 1}, elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int frames, int tokens,
               int heads, float scale, int pitch, int chunk, int smem, int sms,
               cudaStream_t stream) {
  const int bands = (tokens + BAND - 1) / BAND;
  if (pitch != (tokens + 3) / 4 * 4 || chunk < KTILE || chunk % KTILE ||
      smem != 4 * f32_floats(pitch, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  alignas(64) CUtensorMap mq, mk, mv;
  if (!encode_item(&mq, q, frames, tokens, heads) || !encode_item(&mk, k, frames, tokens, heads) ||
      !encode_item(&mv, v, frames, tokens, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(study_attention_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, study_attention_f32, bands * 32,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const F32Geo g{tokens, heads, frames * heads, pitch, chunk};
  const long long resident = (long long)per_sm * sms;
  const int grid = static_cast<int>(g.items < resident ? g.items : resident);
  study_attention_f32<<<grid, bands * 32, smem, stream>>>(
      mq, mk, mv, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), g, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[N, T, H, 64] bf16 = attention over contiguous bf16 q, k, v [N, T, H,
// 64] (16-byte aligned) in numerics mode `mode` (kF32, kBf16, kDiet,
// kDietNoMax), 1 to 256 tokens. kF32 takes Q^T's pitch, its key chunk and
// its shared memory from ops/_cuda.py study_geometry (checked here); the
// other modes ignore the three.
extern "C" int dfd_study_attention(const void* q, const void* k, const void* v, void* out,
                                   int frames, int tokens, int heads, float scale, int mode,
                                   int pitch, int chunk, int smem, void* stream) {
  if (tokens < 1 || tokens > MAX_TOKENS || mode < kF32 || mode > kDietNoMax || frames < 1 ||
      heads < 1 || (long long)frames * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return launch_f32(q, k, v, out, frames, tokens, heads, scale, pitch, chunk, smem, sms, s);
    case kBf16:
      return launch_tc<kBf16>(q, k, v, out, frames, tokens, heads, scale, sms, s);
    case kDiet:
      return launch_tc<kDiet>(q, k, v, out, frames, tokens, heads, scale, sms, s);
    default:
      return launch_tc<kDietNoMax>(q, k, v, out, frames, tokens, heads, scale, sms, s);
  }
}
