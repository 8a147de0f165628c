// Element types of the kernels' inputs and outputs, and their conversion to
// and from f32, in which every kernel computes (as every Pallas kernel of the
// JAX package upcasts its inputs to f32).
//
// Dtype codes passed through the C entry points: 0 float32, 1 bfloat16,
// 2 float16 (mxnet_tpu_torch/ops/kernels/_build.py::DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace mx {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

using bf16 = __nv_bfloat16;
using f16 = __half;

// The dtype code of an element type.
template <typename T>
constexpr int dtype_of();
template <>
constexpr int dtype_of<float>() { return kF32; }
template <>
constexpr int dtype_of<bf16>() { return kBF16; }
template <>
constexpr int dtype_of<f16>() { return kF16; }

inline bool bad_dtype(int dt) { return dt < kF32 || dt > kF16; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ f16 from_f32<f16>(float x) { return __float2half_rn(x); }

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / (int)sizeof(T);
};

// N = 16 / sizeof(T) elements from a 16-byte aligned address, as f32.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) f[i] = to_f32(e[i]);
}

// The same through the read-only path, for device memory.
template <typename T>
__device__ __forceinline__ void ldg16(const T* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) f[i] = to_f32(e[i]);
}

// N f32 values rounded to T and stored as one 16-byte vector.
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) e[i] = from_f32<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Element i of an array whose type is known only at run time.
__device__ __forceinline__ float load_dt(const void* p, size_t i, int dt) {
  if (dt == kBF16) return to_f32(static_cast<const bf16*>(p)[i]);
  if (dt == kF16) return to_f32(static_cast<const f16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_dt(void* p, size_t i, int dt, float v) {
  if (dt == kBF16)
    static_cast<bf16*>(p)[i] = from_f32<bf16>(v);
  else if (dt == kF16)
    static_cast<f16*>(p)[i] = from_f32<f16>(v);
  else
    static_cast<float*>(p)[i] = v;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace mx
