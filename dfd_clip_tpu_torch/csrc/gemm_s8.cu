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
// QuickGELU. S8Op (csrc/gemm_ops.cuh) holds the loads, products and
// epilogue; the whole-encoder tower (csrc/encoder_tower.cu) runs the same
// frame and Op.
#include "gemm_ops.cuh"

using namespace hgemm;

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
  using F = S8Op;
  int bn = 0, sms = 0;
  const int err = tile_n(M, N, &bn, &sms);
  if (err != 0) return err;
  alignas(64) CUtensorMap ma, mb;
  if (!encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, A, K, M, lda, KBYTES, BM) ||
      !encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, B, K, N, ldb, KBYTES,
                 bn == 256 ? bn / Layout<256>::CLUSTER : bn))
    return static_cast<int>(cudaErrorInvalidValue);
  Out out{C, res, ldc, ldr, M, N, flags, (flags & F::kResF32) != 0,
          (flags & F::kStore) != 0,
          Export{static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), tokens, t_out, lo, width,
                 col_off}};
  if (!(flags & (F::kResF32 | F::kResBf16 | F::kResAfterCast))) out.res = nullptr;
  const S8Op::Params p{out, a_scale, w_scale, bias};
  const int form = (flags & F::kGelu ? kFormGelu : 0) |
                   (flags & (F::kResF32 | F::kResBf16) ? kFormRes : 0) |
                   (flags & F::kResAfterCast ? kFormResStore : 0) |
                   (flags & F::kExport ? kFormExport : 0) | (flags & F::kOutF32 ? kFormOut32 : 0);
  return bn == 256 ? launch<S8Op, 256>(form, ma, mb, p, M, N, K, sms, stream)
                   : launch<S8Op, 64>(form, ma, mb, p, M, N, K, sms, stream);
}
