// Storage-type helpers shared by every kernel: float32 or bfloat16 in
// device memory, float32 in registers and shared memory.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hm {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the storage type T (round to nearest even), as float
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// N consecutive elements of T <-> floats, moved as 8- or 16-byte words;
// p must be aligned to min(16, N * sizeof(T)) bytes
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float v[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  static_assert(kBytes == 8 || kBytes % 16 == 0, "8- or 16-byte words");
  if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_f(e[k]);
  } else {
    constexpr int kPerWord = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPerWord; ++k) v[i * kPerWord + k] = to_f(e[k]);
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float v[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  static_assert(kBytes == 8 || kBytes % 16 == 0, "8- or 16-byte words");
  if constexpr (kBytes == 8) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) e[k] = from_f<T>(v[k]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    constexpr int kPerWord = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < kPerWord; ++k) e[k] = from_f<T>(v[i * kPerWord + k]);
      reinterpret_cast<uint4*>(p)[i] = raw;
    }
  }
}

}  // namespace hm
