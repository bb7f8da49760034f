// Shared helpers of the port's CUDA kernels.
//
// Every C entry point takes raw device pointers and a cudaStream_t passed as
// void* (PyTorch's current stream), launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

#define MPA_EXPORT extern "C" __attribute__((visibility("default")))

namespace mpa {

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mpa
