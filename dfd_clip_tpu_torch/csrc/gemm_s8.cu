// int8 x int8 -> int32 GEMM with the W8A8 dequant epilogue of the int8
// encoder blocks: one persistent, warp-specialised sm_90a kernel (TMA
// loads, wgmma products).
//
// Replaces: the in-kernel W8A8 products of dfd_clip_tpu/ops/pallas_attention.py
// (_w8a8_dot with the per-row activation scales of _quant_rows and the
// per-channel weight scales of quantize_weight / weight_q) in
// _make_full_block_kernel (qkv + K/V export, out-proj + f32 residual, c_fc +
// QuickGELU, c_proj + f32 residual), in the int8 split pair and in the int8
// `last_only` form of _make_attn_block_kernel.
//
// Bound on an H100: at encoder shapes (M = 320 frames x 197 tokens or more,
// K = 768 to 4096) the product needs 2 M N K int8 operations at 1979 TOP/s
// against M K + N K bytes of operands and 2-4 bytes per output element at
// 3.35 TB/s: near balance. At the ViT-B qkv shape with a bf16 output the
// operations take 0.1127 ms and the bytes 0.10 ms, so the epilogue's
// stores cost as much as the main loop's products.
//
// Design: the frame of csrc/gemm_hopper.cuh, shared with gemm.cu (whose
// header describes the clustered tile walk, the TMA producer, the ring, the
// two consumer warpgroups, the store warps and the epilogue forms). Here a
// stage holds 128 bytes of K of both operands: A (M, K) in boxes of 128 x
// 128 rows, the weight stored transposed (N, K) in boxes of 128 x BN / 2
// rows (one a CTA of the cluster, multicast to both), both K-major in the
// 128-byte swizzle (int8 wgmma has no transpose), 48 KB a stage at BN = 256.
// The products are wgmma m64n256k32 s32.s8.s8, four k32 steps a stage; the
// int32 sum is exact (K x 127^2 < 2^31 up to K = 133,000), so the order of
// the products does not matter. The epilogue follows the TPU kernel's order
// of f32 operations: acc * (a_s / 127) * (w_s / 127) + bias, QuickGELU, the
// f32 residual add, then the store as f32 or bf16 and, on the qkv
// projection, the K/V export of the bf16 values into slot views of the
// stacked (Lsel, N, T', W) buffers with the frame's zero pad rows; w_s / 127
// is divided once a tile in shared memory and a_s / 127 once a row, the
// same IEEE quotients. The int8 MLP half of the split pair
// (_make_mlp_block_kernel) rounds its c_proj output to bf16 before it adds
// the bf16 residual (kResAfterCast, added by the store warps). The products
// and sums are written with __fmul_rn / __fadd_rn so the compiler fuses none
// of them into an FMA, and QuickGELU's 1 / (1 + exp) is rcp_rn, the same
// round-to-nearest quotient as the division: the
// kernel equals its plain version bit for bit in every form without
// QuickGELU. csrc/gemm_s8_tile.cuh keeps the earlier mma.sync body for the
// tower (csrc/encoder_tower.cu) alone.
#include "gemm_hopper.cuh"

namespace {

using namespace hgemm;

enum : int {
  kGelu = 1,       // v = v * sigmoid(1.702 v)         (f32)
  kResF32 = 2,     // v = res + v, res f32              (f32)
  kResBf16 = 4,    // v = res + v, res bf16 widened     (f32)
  kOutF32 = 8,     // C is f32 (else bf16)
  kStore = 16,     // write C
  kExport = 32,    // write the K/V columns into the stacked export buffers
  kResAfterCast = 64,   // v = res + bf16(v), res bf16    (bf16 output)
};

struct S8Op {
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

}  // namespace

// C = epilogue(A[M,K] int8 @ B[N,K]^T int8) with a_scale (M,), w_scale (N,)
// and bias (N,) f32; res (f32 or bf16, leading dimension ldr) and C (f32 or
// bf16, leading dimension ldc) as the flags say. K % 64 == 0, N % 8 == 0,
// 16-byte aligned bases, the int8 leading dimensions multiples of 16 and the
// others of 8 (the wrapper checks). Returns the launch's cudaGetLastError().
extern "C" int dfd_gemm_s8(const void* A, int lda, const float* a_scale, const void* B, int ldb,
                           const float* w_scale, const float* bias, const void* res, int ldr,
                           void* C, int ldc, int M, int N, int K, int flags, void* k_out,
                           void* v_out, int tokens, int t_out, int lo, int width, int col_off,
                           void* stream) {
  int bn = 0, sms = 0;
  const int err = tile_n(M, N, &bn, &sms);
  if (err != 0) return err;
  alignas(64) CUtensorMap ma, mb;
  if (!encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, K, M, lda, KBYTES, BM) ||
      !encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, B, K, N, ldb, KBYTES,
                 bn == 256 ? bn / Layout<256>::CLUSTER : bn))
    return static_cast<int>(cudaErrorInvalidValue);
  Out out{C, res, ldc, ldr, M, N, flags, (flags & kResF32) != 0,
          (flags & kStore) != 0,
          Export{static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), tokens, t_out, lo, width,
                 col_off}};
  if (!(flags & (kResF32 | kResBf16 | kResAfterCast))) out.res = nullptr;
  const S8Op::Params p{out, a_scale, w_scale, bias};
  const int form = (flags & kGelu ? kFormGelu : 0) | (flags & (kResF32 | kResBf16) ? kFormRes : 0) |
                   (flags & kResAfterCast ? kFormResStore : 0) |
                   (flags & kExport ? kFormExport : 0) | (flags & kOutF32 ? kFormOut32 : 0);
  return bn == 256 ? launch<S8Op, 256>(form, ma, mb, p, M, N, K, sms, stream)
                   : launch<S8Op, 64>(form, ma, mb, p, M, N, K, sms, stream);
}
