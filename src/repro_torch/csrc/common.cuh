// Helpers shared by the kernels: vector loads that widen bf16 or f32 rows
// to f32 registers, narrowing stores, and the finite mask value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// -2**30: the reference's finite mask.  A row whose every key is masked
// then averages V instead of producing NaN, as kernels/ref.py does.
constexpr float kNegInf = -1073741824.0f;

// dtype codes of the C interface (the Python wrappers pass these)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Load E contiguous elements of T at p (16-byte-aligned when E*sizeof(T)
// is a multiple of 16) into f32 registers.  E * sizeof(T) must be a
// multiple of 4.
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* out) {
  constexpr int W = E * static_cast<int>(sizeof(T)) / 4;  // 32-bit words
  static_assert(W * 4 == E * static_cast<int>(sizeof(T)), "row not word sized");
  uint32_t w[W];
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = u.x; w[2 * i + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Store two f32 values as two contiguous elements of T.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Store four f32 values as four contiguous elements of T.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float f4get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

}  // namespace repro
