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
#include <map>
#include <mutex>
#include <utility>

#define MPA_EXPORT extern "C" __attribute__((visibility("default")))

namespace mpa {

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Opt a kernel into the dynamic shared memory it asks for. A launch needs
// the opt-in once its dynamic and static shared memory together pass 48 KB
// (fps_kernel at 4096 3-channel points asks for exactly 48 KB of dynamic and
// has 272 bytes of static). The opt-in is harmless below that, and it costs
// a CUDA runtime call, so each kernel is opted in once for each larger size
// it asks for on each device, not at every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> granted;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = granted[{reinterpret_cast<const void*>(kernel), device}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) have = bytes;
  return err;
}

// Set a kernel's function attribute once on each device (cached as
// allow_smem's opt-in is).
template <typename Kernel>
inline cudaError_t allow_attribute(Kernel kernel, cudaFuncAttribute attr, int value) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<std::pair<const void*, int>, int>, int> set;
  std::lock_guard<std::mutex> lock(mu);
  auto key = std::make_pair(std::make_pair(reinterpret_cast<const void*>(kernel), device),
                            static_cast<int>(attr));
  auto it = set.find(key);
  if (it != set.end() && it->second == value) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) set[key] = value;
  return err;
}

}  // namespace mpa
