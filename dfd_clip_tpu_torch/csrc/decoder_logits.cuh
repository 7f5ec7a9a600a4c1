// The per-token arithmetic of the single-query decoder attention, shared by
// its forward (csrc/decoder_attention.cu) and its backward
// (csrc/decoder_attention_bwd.cu): the backward recomputes the forward's
// softmax logits from the saved maximum, so exp(ls - max) must be the
// forward's value and stay <= 1. Both kernels call token_logits with the
// same lane layout, so the logits agree bit for bit.
//
// Lane layout: a token's 64 dims are spread over a group of 8 lanes, 8
// dims a lane (one 16-byte bf16 word); a warp holds 4 tokens at a time.
// Each lane sums its 8 dims in order with fused multiply-adds written out
// (no contraction left to the compiler), and the group adds its 8 partial
// sums by a fixed butterfly (xor 4, 2, 1), so every lane of the group gets
// the same bits.
#pragma once

#include "common.cuh"

namespace dec {

constexpr int D = 64;               // head_dim
constexpr int DL = 8;               // dims a lane
constexpr int GROUP = D / DL;       // lanes a token
constexpr int TOKENS = 32 / GROUP;  // tokens a warp holds at a time
constexpr float NEG_BIG = -1e30f;   // the running maximum's finite start (the TPU kernel's)

// Sum over the 8 lanes of a token's group.
__device__ __forceinline__ float group_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
}

// Eight bf16 values (a 16-byte word, the first in the low half) as f32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[DL]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Eight int8 values (8 bytes) times `scale` in f32: each byte is placed in
// the mantissa of 2^23 + 128 (offset by 128), so the float is exact and
// needs no conversion instruction; the product is __fmul_rn((float)q, scale).
__device__ __forceinline__ void unpack8(const uint2& u, float scale, float (&f)[DL]) {
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float biased = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440 | (i % 4)));
    f[i] = __fmul_rn(__fsub_rn(biased, 8388736.0f), scale);
  }
}

struct Logits {
  float ls;   // softmax logit: q_smax . (k + pos) * scale
  float lc;   // CoDA logit: q_coda . (k + pos) * scale
  float l1;   // |q_coda - (k + pos)|_1
};

// The logits of the token whose 8 dims of K this lane holds in k (f32);
// adds pos to k in place (k + pos in f32, as the plain version does).
__device__ __forceinline__ Logits token_logits(const float (&qs)[DL], const float (&qc)[DL],
                                               float (&k)[DL], const float (&pos)[DL],
                                               float scale) {
#pragma unroll
  for (int e = 0; e < DL; ++e) k[e] = __fadd_rn(k[e], pos[e]);
  float s = __fmul_rn(qs[0], k[0]), c = __fmul_rn(qc[0], k[0]);
  float a = fabsf(__fsub_rn(qc[0], k[0]));
#pragma unroll
  for (int e = 1; e < DL; ++e) {
    s = __fmaf_rn(qs[e], k[e], s);
    c = __fmaf_rn(qc[e], k[e], c);
    a = __fadd_rn(a, fabsf(__fsub_rn(qc[e], k[e])));
  }
  return {__fmul_rn(group_sum(s), scale), __fmul_rn(group_sum(c), scale), group_sum(a)};
}

}  // namespace dec
