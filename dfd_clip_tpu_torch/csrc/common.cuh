// Shared helpers for the port's Hopper kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// Round a float to bf16 and back: the rounding points of the JAX kernels
// (an `.astype(bfloat16)` in the middle of a float expression).
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16-byte asynchronous global->shared copy; `pred` false fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int size = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Two floats as one bf16x2 register, the first in the low half (a
// tensor-core A or B fragment register).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Maximum and sum over the four lanes of a quad, which hold one row of an
// mma / wgmma accumulator fragment.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Eight bf16 values moved as one 16-byte word.
union Pack8 {
  uint4 u;
  bf16 h[8];
};

// Eight consecutive f32 or bf16 values of a 16-byte aligned row, widened
// to f32.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  Pack8 pk;
  pk.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(pk.h[e]);
}

// The _quant_rows rounding of one f32 value: clip(round(v * mul), -127, 127)
// with round half to even (rintf) and no fused multiply-add.
__device__ __forceinline__ int8_t quant8(float v, float mul) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fmul_rn(v, mul)), -127.0f), 127.0f));
}
