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

// Eight bf16 values moved as one 16-byte word.
union Pack8 {
  uint4 u;
  bf16 h[8];
};
