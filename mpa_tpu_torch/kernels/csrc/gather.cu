// gather_rows_kernel: batched row gather, out[b, e, :] = src[b, idx[b, e], :].
//
// Replaces mpa_tpu/ops/pallas/gather_pallas.py::loop_gather_rows (kernel body
// _loop_gather_kernel; its batch-grid variant _loop_gather_kernel_bg has the
// same semantics). Contract: src [B,N,W] f32, idx [B,E] int32 in [0, N) ->
// out [B,E,W] f32. Forward only.
//
// What bounds it on the H100: bytes. It reads E rows of W floats and writes
// as many, so the bound is 2*B*E*W*4 bytes over the memory rate; at the
// paths' small launches (a few hundred KB) what a launch costs comes first,
// then the two dependent loads (the index, then the row). The TPU's
// scalar-prefetch row loop is a TPU layout and is not carried over.
//
// Design: one flat grid over the output's B*E*W/VEC columns of VEC floats
// (float4 where W % 4 == 0 and both pointers are 16-byte aligned, float2
// where W is even and they are 8-byte aligned, else scalar), ELEMS columns
// a thread, 256 apart, all loads issued before the first store; 32-bit
// index arithmetic (a column's row is i / (W/VEC), the row's cloud row / E).
// Neighbouring threads copy neighbouring columns, so every warp's loads and
// stores are coalesced, and a row's index is loaded by its columns' lanes
// from one address, one transaction a warp. A thread holds few registers,
// so an SM keeps 2048 threads resident. ops/gather.py::gather_form picks
// VEC and ELEMS.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<1> { using T = float; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<4> { using T = float4; };

template <int VEC, int ELEMS>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                   float* __restrict__ out, int N, int E, int wv, int total) {
  using T = typename Vec<VEC>::T;
  const T* s = reinterpret_cast<const T*>(src);
  T* o = reinterpret_cast<T*>(out);
  const int i0 = blockIdx.x * (THREADS * ELEMS) + threadIdx.x;
  T v[ELEMS];
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int i = i0 + k * THREADS;
    if (i < total) {
      const unsigned r = static_cast<unsigned>(i) / static_cast<unsigned>(wv);
      const unsigned c = static_cast<unsigned>(i) - r * static_cast<unsigned>(wv);
      const int b = static_cast<int>(r / static_cast<unsigned>(E));
      v[k] = __ldg(s + static_cast<size_t>(b * N + __ldg(idx + r)) * wv + c);
    }
  }
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int i = i0 + k * THREADS;
    if (i < total) o[i] = v[k];
  }
}

template <int VEC, int ELEMS>
cudaError_t launch(const float* src, const int* idx, float* out, int N, int E, int wv, int total,
                   cudaStream_t stream) {
  const int blocks = mpa::ceil_div(total, THREADS * ELEMS);
  gather_rows_kernel<VEC, ELEMS><<<blocks, THREADS, 0, stream>>>(src, idx, out, N, E, wv, total);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_elems(const float* src, const int* idx, float* out, int N, int E, int wv,
                         int total, int elems, cudaStream_t stream) {
  switch (elems) {
    case 1: return launch<VEC, 1>(src, idx, out, N, E, wv, total, stream);
    case 2: return launch<VEC, 2>(src, idx, out, N, E, wv, total, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src [B,N,W] f32, idx [B,E] int32, out [B,E,W] f32, all contiguous, in
// ops/gather.py::gather_form's form: vec floats a column (1, 2 or 4,
// dividing W, both pointers aligned to it) and elems columns a thread (1 or
// 2). Requires B * N and B * E * W below 2^31 (checked by the Python
// wrapper).
MPA_EXPORT int mpa_gather_rows(const void* src, const void* idx, void* out, int B, int N,
                               int E, int W, int vec, int elems, void* stream) {
  const auto align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  if ((vec != 1 && vec != 2 && vec != 4) || W % vec != 0 || align % (4 * vec) != 0)
    return cudaErrorInvalidValue;
  const int wv = W / vec;
  const int total = B * E * wv;
  if (total == 0) return cudaSuccess;
  cudaStream_t st = mpa::as_stream(stream);
  const auto s = static_cast<const float*>(src);
  const auto ip = static_cast<const int*>(idx);
  const auto o = static_cast<float*>(out);
  if (vec == 4) return launch_elems<4>(s, ip, o, N, E, wv, total, elems, st);
  if (vec == 2) return launch_elems<2>(s, ip, o, N, E, wv, total, elems, st);
  return launch_elems<1>(s, ip, o, N, E, wv, total, elems, st);
}
