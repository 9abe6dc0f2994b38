// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tce {

constexpr float NEG_INF = -1e30f;  // same finite mask value as the JAX kernels

template <typename T>
__device__ __forceinline__ float to_float(T v);

template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an fp32 value to bf16 and back (the JAX kernels' p.astype(bf16))
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, width));
  return v;
}

__device__ __forceinline__ float warp_sum(float v, int width = 32) {
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, width);
  return v;
}

}  // namespace tce
