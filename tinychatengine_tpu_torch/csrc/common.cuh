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

// The attention kernels' K/V storage: bf16 values, or int8 codes with one
// f32 scale per (row, head, position) kept beside them (the JAX package's
// kv_cache_dtype="int8"). A tile moves whole 32-bit words of a row from
// device memory (int8: four codes a word, half the bytes of bf16) and
// stages them into shared memory as bf16 pairs, the layout every tile
// loop reads: an int8 code is exact in bf16 (|code| <= 128), so each code
// is converted once per tile, not once per query head that reads it.
template <typename KV>
struct KVStore;

template <>
struct KVStore<__nv_bfloat16> {
  static constexpr bool kInt8 = false;
  static constexpr int kPerWord = 2;  // elements in one device word
  __device__ static __forceinline__ void stage(uint32_t w, uint32_t* dst) {
    dst[0] = w;
  }
  // a 16-byte vector (8 values) into 4 staged words (16-byte aligned)
  __device__ static __forceinline__ void stage16(uint4 w, uint32_t* dst) {
    *reinterpret_cast<uint4*>(dst) = w;
  }
};

template <>
struct KVStore<int8_t> {
  static constexpr bool kInt8 = true;
  static constexpr int kPerWord = 4;
  __device__ static __forceinline__ void stage(uint32_t w, uint32_t* dst) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          static_cast<float>(static_cast<int8_t>((w >> (16 * h)) & 0xffu)),
          static_cast<float>(static_cast<int8_t>((w >> (16 * h + 8)) & 0xffu)));
      dst[h] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  // a 16-byte vector (16 codes) into 8 staged words (16-byte aligned)
  __device__ static __forceinline__ void stage16(uint4 w, uint32_t* dst) {
    uint32_t o[8];
    stage(w.x, o);
    stage(w.y, o + 2);
    stage(w.z, o + 4);
    stage(w.w, o + 6);
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(dst + 4) = make_uint4(o[4], o[5], o[6], o[7]);
  }
};

// A masked-in score of the int8 cache: (q . code) * sm_scale, then times
// the key's scale, two roundings as the TPU kernel's two multiplies (no
// contraction by nvcc).
__device__ __forceinline__ float scaled_score(float dot, float sm_scale,
                                              float k_scale) {
  return __fmul_rn(__fmul_rn(dot, sm_scale), k_scale);
}

}  // namespace tce
