// The megakernel probe's chained product: `layers` times h = bf16(h @ W_l)
// over rows of width w, f32 accumulate, no bias.
//
// Replaces: tools/bench_megakernel_probe.py per_layer_calls (12 pallas
// calls, h through device memory between them: the wrapper launches this
// kernel once a layer) and megakernel (one pallas call over the grid
// (chunks, layers), the chunk's h carried in the revisited output window:
// one launch of this kernel with the layer sweep inside).
//
// Bound on an H100 at the probe's (63040, 768) x (768, 768) x 12: 0.89
// TFLOP on the bf16 tensor cores (0.90 ms at 989 TFLOP/s) against 97 MB of
// h in, 97 MB out and 14 MB of weights (0.06 ms at 3.35 TB/s): operations.
//
// Design: one block owns 64 rows and carries their h in shared memory
// across the layers, in two bf16 buffers of 64 x (w + 8) that ping-pong
// (194 KB at w = 768). Rows are independent, so no block waits for another
// and no grid-wide barrier is needed: the layer sweep is a loop inside the
// block. A layer computes its output in column tiles of 128 (8 warps of 32 x
// 32, nvcuda::wmma m16n16k16, f32 accumulate); the weight tiles (32 x 128)
// stream from device memory, where the 12 layers' 14 MB stay in the 50 MB
// L2, through a 3-stage cp.async ring that doubles as the epilogue's f32
// staging. The per-layer entry runs the same block body with layers = 1
// (h read, one layer, h written), so both entries do the same arithmetic in
// the same k-order and their results are bit-equal.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int MAX_W = 768;
constexpr int LDB = BN + 8;              // shared-memory pitch (bf16) of a weight tile
constexpr int B_STAGE = BK * LDB;        // bf16 elements per ring stage

__host__ __device__ inline size_t smem_bytes(int w) {
  return (size_t)2 * BM * (w + 8) * 2 + (size_t)STAGES * B_STAGE * 2;
}

// hout[64, w] = bf16(hin[64, w] @ W[w, w]), both in shared memory at pitch
// w + 8; Bs is the weight ring.
__device__ __forceinline__ void layer(const bf16* hin, bf16* hout, const bf16* __restrict__ W,
                                      int w, bf16* Bs) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;   // 2 x 4 warps of 32 x 32
  const int ldh = w + 8;
  const int ktiles = w / BK;
  for (int n0 = 0; n0 < w; n0 += BN) {
    auto load_b = [&](int buf, int k0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // 32 rows x 16 chunks of 8
        const int c = tid + i * THREADS;
        const int r = c / 16, cc = (c % 16) * 8;
        cp_async16(&Bs[buf * B_STAGE + r * LDB + cc], W + (size_t)(k0 + r) * w + n0 + cc, true);
      }
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) load_b(s, s * BK);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<STAGES - 2>();   // tile kt has landed
      __syncthreads();               // ... and every warp is done with kt - 1
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) load_b(nk % STAGES, nk * BK);
      cp_async_commit();
      const bf16* bt = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], hin + (wm * 32 + i * 16) * ldh + kt * BK + kk, ldh);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], bt + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is drained: its first 8 KB stage the epilogue

    float* st = reinterpret_cast<float*>(Bs) + warp * 16 * 16;
    const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        Pack8 pk;
#pragma unroll
        for (int e = 0; e < 8; ++e) pk.h[e] = __float2bfloat16(st[er * 16 + ec + e]);
        *reinterpret_cast<uint4*>(hout + (wm * 32 + i * 16 + er) * ldh + n0 + wn * 32 + j * 16 +
                                  ec) = pk.u;
        __syncwarp();
      }
    __syncthreads();   // the staging is the next column tile's ring
  }
}

__global__ void __launch_bounds__(THREADS)
gemm_chain_kernel(const bf16* __restrict__ h, bf16* __restrict__ out, const bf16* __restrict__ ws,
                  int rows, int w, int layers) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = w + 8;
  bf16* buf[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem) + BM * ldh};
  bf16* Bs = buf[1] + BM * ldh;
  const int r0 = blockIdx.x * BM;
  const int valid = min(BM, rows - r0);
  const int chunks = w / 8;
  for (int c = threadIdx.x; c < BM * chunks; c += THREADS) {
    const int r = c / chunks, cc = (c % chunks) * 8;
    const bool ok = r < valid;
    cp_async16(&buf[0][r * ldh + cc], h + (size_t)(r0 + (ok ? r : 0)) * w + cc, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int l = 0; l < layers; ++l)
    layer(buf[l & 1], buf[(l + 1) & 1], ws + (size_t)l * w * w, w, Bs);
  const bf16* hl = buf[layers & 1];
  for (int c = threadIdx.x; c < valid * chunks; c += THREADS) {
    const int r = c / chunks, cc = (c % chunks) * 8;
    *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * w + cc) =
        *reinterpret_cast<const uint4*>(&hl[r * ldh + cc]);
  }
}

}  // namespace

// out[rows, w] = h after `layers` products h = bf16(h @ ws[l]), ws [layers,
// w, w] contiguous bf16, h and out contiguous bf16 (out may not alias h); w
// a multiple of 128, at most 768.
extern "C" int dfd_gemm_chain(const void* h, void* out, const void* ws, int rows, int w,
                              int layers, void* stream) {
  if (rows < 1 || layers < 1 || w < BN || w > MAX_W || w % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(gemm_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_chain_kernel<<<(rows + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<bf16*>(out), static_cast<const bf16*>(ws), rows,
      w, layers);
  return static_cast<int>(cudaGetLastError());
}
