// Helpers shared by the psg_tpu_torch kernels: element loads and stores in
// fp32 or bf16, and the error-string export every library carries.
//
// Each .cu file is built into its own shared library with a plain C
// interface (see ops/cuda_build.py).  dtype codes passed from Python:
// 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace psg {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Raise the dynamic shared-memory limit of `kernel` when a launch needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace psg

extern "C" const char* psg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
