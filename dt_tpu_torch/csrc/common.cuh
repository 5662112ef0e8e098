// Helpers shared by the port's CUDA sources: element conversions, 16-byte
// vector packs and the alignment test.  Each source is its own library with a
// plain C interface; this header is included, not linked.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dt {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 result to T's precision and back (identity for f32).
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace dt

#define DT_CUDA_ERROR_STRING                                   \
  extern "C" const char* dt_cuda_error_string(int err) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(err));  \
  }
