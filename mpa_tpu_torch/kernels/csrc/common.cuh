// Shared helpers of the port's CUDA kernels.
//
// Every C entry point takes raw device pointers and a cudaStream_t passed as
// void* (PyTorch's current stream), launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>
#include <map>
#include <type_traits>
#include <mutex>
#include <utility>

#define MPA_EXPORT extern "C" __attribute__((visibility("default")))

namespace mpa {

inline cudaStream_t as_stream(void* s) { return reinterpret_cast<cudaStream_t>(s); }

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// bf16 storage. A bf16 is the top half of a float's bits, so widening is
// exact; narrowing rounds to nearest even (__float2bfloat16_rn), as
// torch's .to(torch.bfloat16) and JAX's astype do. The kernels that take
// bf16 read and write it in storage and do their arithmetic in float.
using bf16 = __nv_bfloat16;

// VEC consecutive bf16 (1, 2, 4 or 8) as one read-only load of 2 * VEC
// bytes (the pointer aligned to it), kept as the words it brought: two bf16
// a 32-bit word, the lower index in the low half (one bf16 in the high half
// of its word for VEC = 1). Channel i is widened to float where it is read
// (lanes[i]), so a thread that keeps many rows in flight holds them in half
// the registers that floats would take.
template <int VEC>
struct Bf16Lanes {
  static constexpr int kWords = VEC == 1 ? 1 : VEC / 2;
  unsigned w[kWords];

  __device__ __forceinline__ void load(const bf16* p) {
    if constexpr (VEC == 1) {
      w[0] = static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16;
    } else if constexpr (VEC == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else if constexpr (VEC == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
  }

  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (VEC == 1) return __uint_as_float(w[0]);
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
};

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// VEC floats narrowed to bf16 and written as one store of 2 * VEC bytes.
template <int VEC>
__device__ __forceinline__ void store_bf16(bf16* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(bf16_bits(x[0]));
  } else {
    unsigned w[VEC / 2];
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) w[i] = bf16_bits(x[2 * i]) | bf16_bits(x[2 * i + 1]) << 16;
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(p) = w[0];
    }
  }
}

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
