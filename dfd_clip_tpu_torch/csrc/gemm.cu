// bf16 GEMM with the fused epilogues of the encoder and decoder blocks: one
// persistent, warp-specialised sm_90a kernel (TMA loads, wgmma products).
//
// Replaces: the in-kernel GEMMs of dfd_clip_tpu/ops/pallas_attention.py
// (_make_attn_block_kernel: qkv projection + K/V export + out-projection;
// _make_mlp_block_kernel: c_fc + QuickGELU, c_proj + residual;
// _make_full_block_kernel without int8_gemm: its four GEMMs) and of
// dfd_clip_tpu/ops/pallas_decoder_stack.py (_boundary_kernel's linear_bf16).
//
// Bound on an H100: at encoder shapes (M = 320 frames x 197 tokens or more,
// K = 768 to 4096) the product is bound by tensor-core operations (2 M N K
// FLOP at 989 TFLOP/s against 2 (M K + K N + M N) bytes at 3.35 TB/s: about
// 400 FLOP a byte at the ViT-B qkv shape, above the card's ~295), 0.2256 ms
// at (63040, 768) x (768, 2304). At the decoder boundary (M = 16) it is
// bound by the weight's bytes and, in practice, by launch latency.
//
// Design (the frame in csrc/gemm_hopper.cuh, shared with gemm_s8.cu):
// - A persistent grid walks 128 x 256 output tiles with a static stride, N
//   fastest within a row panel of A, so the tiles in flight share a few A
//   panels and the weight stays in L2. The CTAs run in clusters of two that
//   take two row panels at one column tile: each loads half of the weight's
//   tile into both (TMA multicast), which cuts the L2 reads a tile by a
//   third; the grid is the co-resident cluster count. Where
//   the wide tiles would leave SMs idle (the decoder's M = 16), the tiles are
//   128 x 64 and unclustered (a template argument, the same body).
// - One producer thread (its warpgroup set down to 56 registers) issues TMA loads
//   through 2-D tensor maps encoded per launch: A (M, K) in boxes of 64
//   columns (128 bytes) x 128 rows, the weight (K, N) in boxes of 64 columns
//   x 64 rows, both in the 128-byte swizzle that the wgmma descriptors name.
//   The maps' extents are M, N and K, so TMA zero-fills the ragged row,
//   column and depth tiles (K % 64 == 32 included): the main loop has no
//   masks. A ring of 3 stages of 48 KB (4 of 24 KB at 128 x 64), each with a
//   full and an empty mbarrier; every wait traps after 2^26 polls.
// - Two consumer warpgroups (setmaxnreg up to 224) take 64 rows each and
//   run wgmma m64n256k16 f32.bf16.bf16: A K-major, the weight MN-major
//   through the transpose bit (its 64-column boxes 8 KB apart, the
//   descriptor's leading offset). A stage is released as soon as its
//   product group is done (in a cluster, by the consumers of both CTAs); the
//   two consumers' groups keep the tensor cores busy between.
// - Epilogue, in the plain versions' order: the bias (f32 before the bf16
//   cast, the encoder kernels' rule, or bf16 after it, layers.linear's
//   rule), QuickGELU in f32, the bf16 residual after the cast, or the wide
//   forms of the bf16 whole block (the bf16 h or f32 hmid added in f32
//   before the one rounding, f32 or bf16 out). The consumers apply it on the
//   accumulator's registers, with the tile's bias fetched into shared memory
//   and a residual added before the rounding prefetched into L2 while the
//   products run, and write a bf16 tile whole into a shared staging tile;
//   the producer warpgroup's three idle warps store it (16 bytes a lane),
//   adding the bf16 residual after the rounding, and write the K/V export of
//   the qkv projection into the stacked (Lsel, N, T', W) slot views with
//   each frame's zero pad rows, while the consumers run the next tile's
//   products. An f32 tile is stored by the consumers through a per-warp
//   staging slice. QuickGELU's reciprocal is rcp_rn (csrc/hopper.cuh): the
//   round-to-nearest result without the division's branch, which kept the
//   unrolled values from interleaving.
// - Each epilogue form (QuickGELU, a residual, the export, an f32 output) is
//   a kernel of its own: with one kernel for all, the unrolled epilogue's
//   code outran the instruction cache and took about as long as the products.
//   Kernels exist for the forms the wrappers produce (kForms in
//   gemm_hopper.cuh: QuickGELU, a residual or the export, one at a time).
// BF16Op (csrc/gemm_ops.cuh) holds the loads, products and epilogue; the
// whole-encoder tower (csrc/encoder_tower.cu) runs the same frame and Op.
#include "gemm_ops.cuh"

using namespace hgemm;

// C = epilogue(A[M,K] @ B[K,N]); A, B row-major bf16, C bf16 (f32 with
// kOutF32), res bf16 (f32 with kResIsF32), with the given leading
// dimensions. K % 32 == 0, N % 8 == 0, 16-byte aligned bases and every
// leading dimension a multiple of 8 (16-byte rows, as TMA needs); the
// wrapper checks. Returns the launch's cudaGetLastError().
extern "C" int dfd_gemm(const void* A, int lda, const void* B, int ldb, void* C, int ldc,
                        int M, int N, int K, const float* bias, const void* res, int ldr,
                        int flags, void* k_out, void* v_out, int tokens, int t_out, int lo,
                        int width, int col_off, void* stream) {
  using F = BF16Op;
  int bn = 0, sms = 0;
  const int err = tile_n(M, N, &bn, &sms);
  if (err != 0) return err;
  alignas(64) CUtensorMap ma, mb;
  if (!encode_2d(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, A, K, M, 2LL * lda, 64, BM) ||
      !encode_2d(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, B, N, K, 2LL * ldb, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Out out{C, res, ldc, ldr, M, N, flags, (flags & F::kResIsF32) != 0,
          (flags & F::kStore) != 0,
          Export{static_cast<bf16*>(k_out), static_cast<bf16*>(v_out), tokens, t_out, lo, width,
                 col_off}};
  if (!(flags & (F::kResid | F::kResAddF32))) out.res = nullptr;
  const BF16Op::Params p{out, bias};
  const int form = (flags & F::kGelu ? kFormGelu : 0) | (flags & F::kResAddF32 ? kFormRes : 0) |
                   (flags & F::kResid ? kFormResStore : 0) |
                   (flags & F::kExport ? kFormExport : 0) | (flags & F::kOutF32 ? kFormOut32 : 0);
  return bn == 256 ? launch<BF16Op, 256>(form, ma, mb, p, M, N, K, sms, stream)
                   : launch<BF16Op, 64>(form, ma, mb, p, M, N, K, sms, stream);
}
