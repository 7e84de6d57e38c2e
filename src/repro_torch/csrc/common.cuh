// Shared helpers for the port's hand-written Hopper kernels.
#pragma once
#include <cuda_runtime.h>

#define ZP_NEG_INF (-1e30f)

__device__ __forceinline__ float zp_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Dynamic shared memory above the 48 KB default needs an explicit opt-in.
template <typename Kernel>
static cudaError_t zp_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

extern "C" const char* zp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
