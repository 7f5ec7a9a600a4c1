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
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of 256-thread
// blocks, as many as are co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SMs; one a SM, since the attention stage needs ~165-175 KB of
// shared memory at 197 tokens); a grid that cannot be co-resident is
// refused before launch, never run another way. The kernel walks the batch
// in chunks of frames with the layers innermost, as the TPU grid does; each
// stage of a layer loops over its tiles (tile = blockIdx.x; tile < n; tile
// += gridDim.x) and ends in cooperative_groups::this_grid().sync(). The
// stages: LN1 (+ the row quantisation), the qkv GEMM (+ the export), the
// attention, (the row quantisation of its f32 output), the out-projection +
// h -> f32 hmid, LN2 (+ quantisation), c_fc + QuickGELU, (quantisation),
// c_proj + hmid -> bf16 h. The stage bodies are the per-layer kernels' own
// block bodies (csrc/gemm_tile.cuh, gemm_s8_tile.cuh, rows.cuh,
// attention_tile.cuh, attention_stream_tile.cuh, attention_s8_tile.cuh), so
// the tower rounds where the per-layer chain rounds. Above 320 tokens
// (ViT-L/14@336px: 577) the launcher takes a second instantiation of the
// kernel (STREAM), whose attention stage takes the streamed bodies the
// per-layer kernels take there (in one instantiation their register
// footprint made the staged tower spill and run 3.5 % slower at ViT-B): in
// mode "0" the bf16 flash body, whose 4 warps take 64 query rows, so each
// half of a block runs its own item with its own 46 KB of shared memory
// and its own named barrier (two items a block-iteration, no half idle
// while items remain); in modes "1" and "qk" the int8 streamed body, 128
// query rows on all 8 warps. Its shared memory (92 KB, 57 KB, 68 KB) stays
// below the 197-token staged bodies', so the grid stays at one block a SM.
// The layer weights are read through a device array of per-layer pointers
// (LayerW), built once per call by the wrapper from the per-layer parameter
// dicts; nothing is copied or stacked.
//
// Memory: the wrapper allocates one chunk's scratch (h bf16, qkv bf16, the
// attention output, hmid f32, the MLP intermediate, the LayerNorm output or
// the int8 activations and their scales). The chunk plays the part of the
// TPU's VMEM hbuf: its h and qkv, 2 + 6 = 8 bytes x T x W a frame, are kept
// within half of the 50 MB L2 (the other half for the layer's weights, 7 MB
// int8 or 14 MB bf16 at W = 768, and the streamed intermediates): chunk =
// floor(25 MiB / (8 T W)) frames, 21 at ViT-B/16 (8 x 197 x 768 = 1.21 MB a
// frame), 12 at ViT-L/14, 5 at ViT-L/14@336px (8 x 577 x 1024 = 4.7 MB). A
// fixed rule, computed by the wrapper
// (ops/_cuda.py tower_chunk); the last chunk may be shorter. Making the
// stages fast (wgmma, TMA, warp specialisation, fusing the row stages into
// the GEMMs) is later work.
#include <cooperative_groups.h>

#include "attention_s8_tile.cuh"
#include "attention_stream_tile.cuh"
#include "attention_tile.cuh"
#include "gemm_s8_tile.cuh"
#include "gemm_tile.cuh"
#include "rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;

// One layer's parameters (models/clip_vit.py's per-layer dicts).
struct LayerW {
  const void* w[4];     // qkv, out-proj, c_fc, c_proj: bf16 (K, N) row-major, or int8 (N, K)
  const float* ws[4];   // the int8 weights' per-channel scales (N,); unused in bf16
  const float* b[4];    // biases (N,), f32
  const float* ln[4];   // ln_1 scale, ln_1 shift, ln_2 scale, ln_2 shift (W,), f32
};

enum : int { kQkv = 0, kOut = 1, kFc = 2, kProj = 3 };

struct TowerArgs {
  const bf16* h0;         // (frames * tokens, W): the post-embed residual stream
  const LayerW* layers;   // layers 0 .. last
  bf16* k;                // (nsel, frames, t_out, W) exports
  bf16* v;
  int frames, tokens, width, heads, hidden;
  int first, last, lo, t_out, chunk;
  int attn;               // 0: softmax attention in bf16; 1: _attn_int8_cols; 2: its "qk" mode
  float scale;            // d^-1/2
  float coef_qk;          // d^-1/2 / 127^2
  // one chunk's scratch, chunk * tokens rows
  bf16* h;                // the residual stream between layers
  bf16* qkv;              // (rows, 3W)
  void* att;              // (rows, W): bf16, or f32 on the int8 tower
  float* hmid;            // (rows, W)
  void* mid;              // (rows, hidden): bf16, or f32 on the int8 tower
  bf16* y;                // (rows, W): the LayerNorm output (bf16 tower)
  int8_t* aq;             // (rows, hidden): int8 activations (int8 tower)
  float* as;              // (rows,): their scales
};

__device__ __forceinline__ int first_warp() { return blockIdx.x * WARPS + threadIdx.x / 32; }

template <typename T>
__device__ __noinline__ void ln_stage(const T* x, int rows, const float* scale, const float* shift,
                                      bf16* y, int width) {
  for (int r = first_warp(); r < rows; r += gridDim.x * WARPS)
    row_ops::layer_norm(x + (size_t)r * width, scale, shift, y + (size_t)r * width, width, LN_EPS,
                        threadIdx.x % 32);
}

template <typename T>
__device__ __noinline__ void ln_quant_stage(const T* x, int rows, const float* scale,
                                            const float* shift, int width, int8_t* q, float* s) {
  for (int r = first_warp(); r < rows; r += gridDim.x * WARPS)
    row_ops::layer_norm_quant(x, width, r, scale, shift, width, LN_EPS, q, s, threadIdx.x % 32);
}

__device__ __noinline__ void quant_stage(const float* x, int rows, int cols, int8_t* q, float* s) {
  for (int r = first_warp(); r < rows; r += gridDim.x * WARPS)
    row_ops::quant_row(x, cols, r, cols, false, q, cols, s, rows, rows, 0, threadIdx.x % 32);
}

template <bool WIDE>
__device__ __noinline__ void gemm_stage(const bf16* A, int lda, const bf16* B, int ldb, void* C,
                                        int ldc, int M, int N, int K, const float* bias,
                                        const void* res, int ldr, int flags,
                                        bf16_gemm::Export ex, unsigned char* smem) {
  using namespace bf16_gemm;
  const int tn = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();   // every warp is done with the previous tile's shared memory
    tile<WIDE>(A, lda, B, ldb, C, ldc, M, N, K, bias, res, ldr, flags, ex, t / tn * BM,
               t % tn * BN, smem);
  }
}

__device__ __noinline__ void s8_stage(const int8_t* A, int lda, const float* a_scale,
                                      const int8_t* B, int ldb, const float* w_scale,
                                      const float* bias, const void* res, int ldr, void* C,
                                      int ldc, int M, int N, int K, int flags, s8_gemm::Export ex,
                                      unsigned char* smem) {
  using namespace s8_gemm;
  const int tn = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();
    tile<false>(A, lda, a_scale, B, ldb, w_scale, bias, res, ldr, C, ldc, M, N, K, flags, ex,
                t / tn * BM, t % tn * BN, smem);
  }
}

// Above MAX_TOKENS the attention of fc frames' packed qkv rows into att
// takes the streamed bodies: the bf16 body (4 warps, 64 query rows) runs two
// items a block-iteration, one in each half of the block with its own
// shared memory and named barrier, and the int8 body takes 128 query rows
// with all 8 warps. Only the kernel's STREAM instantiation calls it.
template <bool OUT_F32>
__device__ __noinline__ void stream_attention_stage(const TowerArgs& a, int fc,
                                                    unsigned char* smem) {
  const int w = a.heads * attn_bf16::D;
  if (a.attn == 0) {
    const int groups = (a.tokens + attn_stream::BQ - 1) / attn_stream::BQ;
    const int items = fc * a.heads * groups, half = attn_stream::group();
    unsigned char* hs = smem + half * attn_stream::SMEM_BYTES;
    for (int t = 2 * blockIdx.x + half; t < items; t += 2 * gridDim.x) {
      attn_stream::group_sync();
      const int fh = t / groups;
      attn_stream::tile<OUT_F32>(a.qkv, a.qkv + w, a.qkv + 2 * w, 3 * w, a.att, a.tokens,
                                 a.heads, a.scale, fh / a.heads, fh % a.heads,
                                 (t % groups) * attn_stream::BQ, hs);
    }
  } else if constexpr (OUT_F32) {
    float* out = static_cast<float*>(a.att);
    const int chunks = (a.tokens + attn_s8::STREAM_ROWS - 1) / attn_s8::STREAM_ROWS;
    for (int t = blockIdx.x; t < fc * a.heads * chunks; t += gridDim.x) {
      __syncthreads();
      const int fh = t / chunks;
      if (a.attn == 2)
        attn_s8::stream_tile<true>(a.qkv, 3 * w, out, a.tokens, a.heads, a.coef_qk,
                                   fh / a.heads, fh % a.heads, t % chunks, smem);
      else
        attn_s8::stream_tile<false>(a.qkv, 3 * w, out, a.tokens, a.heads, a.coef_qk,
                                    fh / a.heads, fh % a.heads, t % chunks, smem);
    }
  }
}

// The attention of fc frames' packed qkv rows into att (bf16, or f32 for
// the int8 tower, whose attention may also run int8), up to MAX_TOKENS: one
// (frame, head) a block-iteration.
template <bool OUT_F32>
__device__ __noinline__ void attention_stage(const TowerArgs& a, int fc, unsigned char* smem) {
  const int w = a.heads * attn_bf16::D, tiles = fc * a.heads;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();
    const int f = t / a.heads, hd = t % a.heads;
    if (a.attn == 0) {
      if (attn_bf16::geometry(a.tokens).tp <= 256)
        attn_bf16::tile<256, OUT_F32>(a.qkv, a.qkv + w, a.qkv + 2 * w, 3 * w, a.att, a.tokens,
                                      a.heads, a.scale, f, hd, smem);
      else
        attn_bf16::tile<attn_bf16::MAX_TOKENS, OUT_F32>(a.qkv, a.qkv + w, a.qkv + 2 * w, 3 * w,
                                                        a.att, a.tokens, a.heads, a.scale, f, hd,
                                                        smem);
    } else if constexpr (OUT_F32) {
      float* out = static_cast<float*>(a.att);
      const bool narrow = attn_s8::geometry(a.tokens).tp <= 256;
      if (a.attn == 2) {
        if (narrow)
          attn_s8::tile<256, true>(a.qkv, 3 * w, out, a.tokens, a.heads, a.coef_qk, f, hd, smem);
        else
          attn_s8::tile<attn_s8::MAX_TOKENS, true>(a.qkv, 3 * w, out, a.tokens, a.heads,
                                                   a.coef_qk, f, hd, smem);
      } else if (narrow) {
        attn_s8::tile<256, false>(a.qkv, 3 * w, out, a.tokens, a.heads, a.coef_qk, f, hd, smem);
      } else {
        attn_s8::tile<attn_s8::MAX_TOKENS, false>(a.qkv, 3 * w, out, a.tokens, a.heads,
                                                  a.coef_qk, f, hd, smem);
      }
    }
  }
}

// STREAM: the attention stage's streamed bodies (above MAX_TOKENS), a
// kernel of its own so that the staged kernel keeps its registers (the
// streamed bodies' register footprint made the caller spill).
template <bool INT8, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1) encoder_tower_kernel(TowerArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int W = a.width, T = a.tokens, W3 = 3 * W, hid = a.hidden;
  for (int f0 = 0; f0 < a.frames; f0 += a.chunk) {
    const int fc = min(a.chunk, a.frames - f0);
    const int R = fc * T;
    for (int l = 0; l <= a.last; ++l) {
      const LayerW& p = a.layers[l];
      const bf16* hin = l == 0 ? a.h0 + (size_t)f0 * T * W : a.h;
      const bool last = l == a.last;
      bf16 *kx = nullptr, *vx = nullptr;
      if (l >= a.first) {   // slot l - first, frames f0.. of the exports
        const size_t at = ((size_t)(l - a.first) * a.frames + f0) * a.t_out * W;
        kx = a.k + at;
        vx = a.v + at;
      }
      const int col_off = last ? W : 0;   // the last layer: K/V columns only
      // LN1 (+ quantisation), then the qkv projection with the export
      if (INT8) {
        ln_quant_stage<bf16>(hin, R, p.ln[0], p.ln[1], W, a.aq, a.as);
        grid.sync();
        const s8_gemm::Export ex{kx, vx, T, a.t_out, a.lo, W, col_off};
        const int flags = (last ? 0 : s8_gemm::kStore) | (kx ? s8_gemm::kExport : 0);
        s8_stage(a.aq, W, a.as, static_cast<const int8_t*>(p.w[kQkv]) + (size_t)col_off * W, W,
                 p.ws[kQkv] + col_off, p.b[kQkv] + col_off, nullptr, 0, a.qkv, W3, R,
                 W3 - col_off, W, flags, ex, smem);
      } else {
        ln_stage<bf16>(hin, R, p.ln[0], p.ln[1], a.y, W);
        grid.sync();
        const bf16_gemm::Export ex{kx, vx, T, a.t_out, a.lo, W, col_off};
        const int flags = bf16_gemm::kBiasF32 | (last ? 0 : bf16_gemm::kStore) |
                          (kx ? bf16_gemm::kExport : 0);
        gemm_stage<false>(a.y, W, static_cast<const bf16*>(p.w[kQkv]) + col_off, W3, a.qkv, W3,
                          R, W3 - col_off, W, p.b[kQkv] + col_off, nullptr, 0, flags, ex, smem);
      }
      grid.sync();
      if (last) break;
      if constexpr (STREAM)
        stream_attention_stage<INT8>(a, fc, smem);
      else
        attention_stage<INT8>(a, fc, smem);
      grid.sync();
      if (INT8) {
        const s8_gemm::Export none{nullptr, nullptr, 1, 1, 0, 1, 0};
        quant_stage(static_cast<const float*>(a.att), R, W, a.aq, a.as);
        grid.sync();
        s8_stage(a.aq, W, a.as, static_cast<const int8_t*>(p.w[kOut]), W, p.ws[kOut], p.b[kOut],
                 hin, W, a.hmid, W, R, W, W,
                 s8_gemm::kResBf16 | s8_gemm::kOutF32 | s8_gemm::kStore, none, smem);
        grid.sync();
        ln_quant_stage<float>(a.hmid, R, p.ln[2], p.ln[3], W, a.aq, a.as);
        grid.sync();
        s8_stage(a.aq, W, a.as, static_cast<const int8_t*>(p.w[kFc]), W, p.ws[kFc], p.b[kFc],
                 nullptr, 0, a.mid, hid, R, hid, W,
                 s8_gemm::kGelu | s8_gemm::kOutF32 | s8_gemm::kStore, none, smem);
        grid.sync();
        quant_stage(static_cast<const float*>(a.mid), R, hid, a.aq, a.as);
        grid.sync();
        s8_stage(a.aq, hid, a.as, static_cast<const int8_t*>(p.w[kProj]), hid, p.ws[kProj],
                 p.b[kProj], a.hmid, W, a.h, W, R, W, hid, s8_gemm::kResF32 | s8_gemm::kStore,
                 none, smem);
      } else {
        const bf16_gemm::Export none{nullptr, nullptr, 1, 1, 0, 1, 0};
        gemm_stage<true>(static_cast<const bf16*>(a.att), W, static_cast<const bf16*>(p.w[kOut]),
                         W, a.hmid, W, R, W, W, p.b[kOut], hin, W,
                         bf16_gemm::kBiasF32 | bf16_gemm::kOutF32 | bf16_gemm::kResAddF32 |
                             bf16_gemm::kStore,
                         none, smem);
        grid.sync();
        ln_stage<float>(a.hmid, R, p.ln[2], p.ln[3], a.y, W);
        grid.sync();
        gemm_stage<false>(a.y, W, static_cast<const bf16*>(p.w[kFc]), hid,
                          static_cast<bf16*>(a.mid), hid, R, hid, W, p.b[kFc], nullptr, 0,
                          bf16_gemm::kBiasF32 | bf16_gemm::kGelu | bf16_gemm::kStore, none, smem);
        grid.sync();
        gemm_stage<true>(static_cast<const bf16*>(a.mid), hid, static_cast<const bf16*>(p.w[kProj]),
                         W, a.h, W, R, W, hid, p.b[kProj], a.hmid, W,
                         bf16_gemm::kBiasF32 | bf16_gemm::kResAddF32 | bf16_gemm::kResIsF32 |
                             bf16_gemm::kStore,
                         none, smem);
      }
      grid.sync();
    }
  }
}

using TowerKernel = void (*)(TowerArgs);

TowerKernel tower_kernel(int tokens, int int8) {
  if (tokens > attn_bf16::MAX_TOKENS)
    return int8 ? encoder_tower_kernel<true, true> : encoder_tower_kernel<false, true>;
  return int8 ? encoder_tower_kernel<true, false> : encoder_tower_kernel<false, false>;
}

size_t tower_smem(int tokens, int int8, int attn) {
  size_t s = int8 ? s8_gemm::SMEM_BYTES : bf16_gemm::SMEM_BYTES;
  size_t at;
  if (tokens > attn_bf16::MAX_TOKENS)
    at = int8 && attn != 0 ? attn_s8::stream_smem(attn == 2) : 2 * attn_stream::SMEM_BYTES;
  else
    at = int8 && attn != 0 ? attn_s8::geometry(tokens).smem : attn_bf16::geometry(tokens).smem;
  return at > s ? at : s;
}

}  // namespace

// *grid = the largest co-resident grid of the tower kernel for this
// geometry (0 when none can run: more shared memory than a block may have,
// or no cooperative launch on the device). Returns a CUDA error code.
extern "C" int dfd_encoder_tower_grid(int tokens, int int8, int attn, int* grid) {
  *grid = 0;
  auto kernel = tower_kernel(tokens, int8);
  const size_t smem = tower_smem(tokens, int8, attn);
  if (tokens < 1 || smem > attn_bf16::SMEM_LIMIT) return 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = coop ? per_sm * sms : 0;
  return 0;
}

// The tower over h0 (frames * tokens, width) bf16 with the per-layer
// parameter pointers `layers` (LayerW[last + 1] on the device), exporting
// layers first..last into k, v (last - first + 1, frames, t_out, width) bf16.
// int8: the W8A8 tower (weights int8 (N, K) with (N,) scales); attn 0, 1, 2:
// bf16 attention, _attn_int8_cols, its qk mode (int8 only). The scratch
// pointers hold chunk * tokens rows each (see TowerArgs). grid 0 launches the
// largest co-resident grid; a larger grid, or none co-resident, returns -1
// without launching. Otherwise returns the launch's CUDA error code.
extern "C" int dfd_encoder_tower(const void* h0, const void* layers, void* k, void* v, int frames,
                                 int tokens, int width, int heads, int hidden, int first, int last,
                                 int lo, int t_out, int chunk, int int8, int attn, float scale,
                                 float coef_qk, void* h, void* qkv, void* att, void* hmid,
                                 void* mid, void* y, void* aq, void* as, int grid,
                                 void* stream) {
  int max_grid = 0;
  const int err = dfd_encoder_tower_grid(tokens, int8, attn, &max_grid);
  if (err != 0) return err;
  if (max_grid < 1 || grid > max_grid) return -1;
  TowerArgs a{static_cast<const bf16*>(h0), static_cast<const LayerW*>(layers),
              static_cast<bf16*>(k), static_cast<bf16*>(v), frames, tokens, width, heads, hidden,
              first, last, lo, t_out, chunk, attn, scale, coef_qk, static_cast<bf16*>(h),
              static_cast<bf16*>(qkv), att, static_cast<float*>(hmid), mid,
              static_cast<bf16*>(y), static_cast<int8_t*>(aq), static_cast<float*>(as)};
  void* params[] = {&a};
  auto kernel = tower_kernel(tokens, int8);
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid > 0 ? grid : max_grid), dim3(THREADS),
      params, tower_smem(tokens, int8, attn), static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}
