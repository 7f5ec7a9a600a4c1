// The two product types of the GEMM frame (csrc/gemm_hopper.cuh): BF16Op,
// the bf16 GEMM's (csrc/gemm.cu), and S8Op, the W8A8 GEMM's
// (csrc/gemm_s8.cu). Each supplies a stage's TMA loads, its wgmma products
// and the f32 operations of its fused epilogue; the per-layer kernels and
// the whole-encoder tower (csrc/encoder_tower.cu) take the same types, so
// the tower's products sum and round where the per-layer kernels do. The
// designs are described in gemm.cu and gemm_s8.cu.
#pragma once

#include "gemm_hopper.cuh"

namespace hgemm {

struct BF16Op {
  // epilogue flags (ops/_cuda.py mirrors them)
  enum : int {
    kBiasF32 = 1,      // v = acc + b                       (f32)
    kBiasBf16 = 2,     // v = bf16(bf16(acc) + bf16(b))     (layers.linear)
    kGelu = 4,         // v = v * sigmoid(1.702 v)          (f32)
    kResid = 8,        // out = bf16(res + bf16(v)), res bf16
    kStore = 16,       // write C
    kExport = 32,      // write K/V columns into the stacked export buffers
    kOutF32 = 64,      // C is f32
    kResAddF32 = 128,  // v = res + v in f32 before the output cast
    kResIsF32 = 256,   // ... with an f32 residual (else bf16, widened)
  };
  using Acc = float;
  static constexpr int ELEM = 2;   // bytes of an operand value
  struct Params {
    Out out;
    const float* bias;
  };

  // A stage: A's 128 rows x 64 columns from k0, the weight's 64 rows from k0
  // x BN columns as BN / 64 boxes; in a cluster of two each CTA loads half
  // of the boxes into both.
  template <int BN, int CL>
  static __device__ __forceinline__ void load(uint32_t a, uint32_t b, const CUtensorMap* ma,
                                              const CUtensorMap* mb, uint32_t bar, int kt,
                                              int m0, int n0, int rank) {
    tma_load(a, ma, bar, kt * 64, m0);
    constexpr int NB = BN / 64 / CL;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int j = rank * NB + i;
      if (CL > 1)
        tma_load_multicast(b + j * 64 * KBYTES, mb, bar, n0 + 64 * j, kt * 64, (1 << CL) - 1);
      else
        tma_load(b + j * 64 * KBYTES, mb, bar, n0 + 64 * j, kt * 64);
    }
  }

  // Four k16 steps: 32 bytes along A's swizzled rows, 16 weight rows (2 KB).
  template <int BN>
  static __device__ __forceinline__ void mma(float (&acc)[BN / 2], uint32_t a, uint32_t b,
                                             int kt) {
    const uint64_t da = sw128_desc(a), db = sw128_desc(b, 64 * KBYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16(acc, da + 2 * kk, db + kk * ((16 * 128) >> 4), kt | kk);
  }

  // The epilogue's per-column operand (the bias); no row scale.
  static __device__ __forceinline__ const float* col_src(const Params& p, int i) {
    return i == 0 ? p.bias : nullptr;
  }
  static __device__ __forceinline__ void prepare_col1(float*) {}
  static __device__ __forceinline__ float row_scale(const Params&, int) { return 0.f; }

  // N values of the epilogue, before the output's rounding: the plain
  // versions' f32 operations in their order (each flag tested once for all
  // N; b: the bias of each value's column, r: its residual).
  template <int FORM, int N>
  static __device__ __forceinline__ void apply(const Params& p, const float (&acc)[N],
                                               const float (&b)[N], const float (&)[N],
                                               const float (&)[N], const float (&r)[N],
                                               float (&v)[N]) {
    const int f = p.out.flags;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = acc[i];
    if (f & kBiasF32) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += b[i];
    }
    if (f & kBiasBf16) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = bf16r(bf16r(v[i]) + bf16r(b[i]));
    }
    if (FORM & kFormGelu) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = v[i] * rcp_rn(1.0f + expf(-1.702f * v[i]));
    }
    if ((FORM & kFormRes) && (f & kResAddF32)) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = r[i] + v[i];
    }
  }
};

struct S8Op {
  // epilogue flags (ops/_cuda.py mirrors them)
  enum : int {
    kGelu = 1,            // v = v * sigmoid(1.702 v)         (f32)
    kResF32 = 2,          // v = res + v, res f32              (f32)
    kResBf16 = 4,         // v = res + v, res bf16 widened     (f32)
    kOutF32 = 8,          // C is f32 (else bf16)
    kStore = 16,          // write C
    kExport = 32,         // write the K/V columns into the stacked export buffers
    kResAfterCast = 64,   // v = res + bf16(v), res bf16    (bf16 output)
  };
  using Acc = int;
  static constexpr int ELEM = 1;   // bytes of an operand value
  struct Params {
    Out out;
    const float* a_scale;
    const float* w_scale;
    const float* bias;
  };

  // A stage: A's 128 rows and the weight's BN rows, 128 bytes of K from k0;
  // in a cluster of two each CTA loads half of the weight's rows into both.
  template <int BN, int CL>
  static __device__ __forceinline__ void load(uint32_t a, uint32_t b, const CUtensorMap* ma,
                                              const CUtensorMap* mb, uint32_t bar, int kt,
                                              int m0, int n0, int rank) {
    tma_load(a, ma, bar, kt * KBYTES, m0);
    if (CL > 1)
      tma_load_multicast(b + rank * (BN / CL) * KBYTES, mb, bar, kt * KBYTES,
                         n0 + rank * (BN / CL), (1 << CL) - 1);
    else
      tma_load(b, mb, bar, kt * KBYTES, n0);
  }

  // Four k32 steps, 32 bytes along both operands' swizzled rows.
  template <int BN>
  static __device__ __forceinline__ void mma(int (&acc)[BN / 2], uint32_t a, uint32_t b, int kt) {
    const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kt | kk);
  }

  // The epilogue's per-column operands (the bias, w_scale / 127, divided
  // once a tile in shared memory) and its row scale (a_scale / 127).
  static __device__ __forceinline__ const float* col_src(const Params& p, int i) {
    return i == 0 ? p.bias : p.w_scale;
  }
  static __device__ __forceinline__ void prepare_col1(float* w) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = w[e] / 127.0f;
  }
  static __device__ __forceinline__ float row_scale(const Params& p, int row) {
    return p.a_scale[row] / 127.0f;
  }

  // N values of the epilogue, before the output's rounding: the TPU
  // kernel's f32 operations in their order, none fused (each flag tested
  // once for all N; b, wc: the bias and w_scale / 127 of each value's
  // column, ar: a_scale / 127 of its row, r: its residual).
  template <int FORM, int N>
  static __device__ __forceinline__ void apply(const Params& p, const int (&acc)[N],
                                               const float (&b)[N], const float (&wc)[N],
                                               const float (&ar)[N], const float (&r)[N],
                                               float (&v)[N]) {
    const int f = p.out.flags;
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc[i]), ar[i]), wc[i]), b[i]);
    if (FORM & kFormGelu) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        v[i] = __fmul_rn(v[i], rcp_rn(1.0f + expf(-1.702f * v[i])));
    }
    if ((FORM & kFormRes) && (f & (kResF32 | kResBf16))) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = __fadd_rn(r[i], v[i]);
    }
  }
};

}  // namespace hgemm
