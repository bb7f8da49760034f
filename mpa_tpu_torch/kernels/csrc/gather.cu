// gather_rows_kernel: batched row gather, out[b, e, :] = src[b, idx[b, e], :].
//
// Replaces mpa_tpu/ops/pallas/gather_pallas.py::loop_gather_rows (kernel body
// _loop_gather_kernel; its batch-grid variant _loop_gather_kernel_bg has the
// same semantics). Contract: src [B,N,W] f32 or bf16, idx [B,E] int32 in
// [0, N) -> out [B,E,W] of src's type, a bit-exact copy of the rows (the
// TPU kernel moves bf16 rows as they are, gather_pallas.py:309-332).
// Forward only.
//
// What bounds it on the H100: bytes. It reads E rows of W values and writes
// as many, so the bound is 2*B*E*W*sizeof(value) bytes over the memory rate; at the
// paths' small launches (a few hundred KB) what a launch costs comes first,
// then the two dependent loads (the index, then the row). The TPU's
// scalar-prefetch row loop is a TPU layout and is not carried over.
//
// Design: one flat grid over the output's B*E*W/VEC columns of VEC values
// (float4 where W % 4 == 0 and both pointers are 16-byte aligned, float2
// where W is even and they are 8-byte aligned, else scalar; for bf16 rows
// 16, 8, 4 or 2 bytes, 8, 4, 2 or 1 values a column, the same rule in
// bytes: a column is moved as raw bits, never widened), ELEMS columns
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

// The column types: float rows as float4, float2 or float; bf16 rows as raw
// 16, 8, 4 or 2 bytes.
template <typename T, int ELEMS>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const T* __restrict__ s, const int* __restrict__ idx,
                   T* __restrict__ o, int N, int E, int wv, int total) {
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

template <typename T>
cudaError_t launch_elems(const void* src, const int* idx, void* out, int N, int E, int wv,
                         int total, int elems, cudaStream_t stream) {
  const auto s = static_cast<const T*>(src);
  const auto o = static_cast<T*>(out);
  switch (elems) {
    case 1:
      gather_rows_kernel<T, 1><<<mpa::ceil_div(total, THREADS), THREADS, 0, stream>>>(
          s, idx, o, N, E, wv, total);
      return cudaGetLastError();
    case 2:
      gather_rows_kernel<T, 2><<<mpa::ceil_div(total, THREADS * 2), THREADS, 0, stream>>>(
          s, idx, o, N, E, wv, total);
      return cudaGetLastError();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src [B,N,W], idx [B,E] int32, out [B,E,W], all contiguous, src and out of
// elem_bytes bytes a value (4: f32, 2: bf16), in ops/gather.py::gather_form's
// form: vec values a column (f32 1, 2 or 4; bf16 1, 2, 4 or 8; dividing W,
// both pointers aligned to the column's bytes) and elems columns a thread
// (1 or 2). Requires B * N and B * E * W below 2^31 (checked by the Python
// wrapper).
MPA_EXPORT int mpa_gather_rows(const void* src, const void* idx, void* out, int B, int N,
                               int E, int W, int vec, int elems, int elem_bytes, void* stream) {
  const auto align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  const int bytes = vec * elem_bytes;
  if ((elem_bytes != 4 && elem_bytes != 2) || vec < 1 || W % vec != 0 ||
      (bytes != 2 && bytes != 4 && bytes != 8 && bytes != 16) || (elem_bytes == 4 && vec > 4) ||
      align % bytes != 0)
    return cudaErrorInvalidValue;
  const int wv = W / vec;
  const int total = B * E * wv;
  if (total == 0) return cudaSuccess;
  cudaStream_t st = mpa::as_stream(stream);
  const auto ip = static_cast<const int*>(idx);
  if (elem_bytes == 4) {
    if (vec == 4) return launch_elems<float4>(src, ip, out, N, E, wv, total, elems, st);
    if (vec == 2) return launch_elems<float2>(src, ip, out, N, E, wv, total, elems, st);
    return launch_elems<float>(src, ip, out, N, E, wv, total, elems, st);
  }
  if (bytes == 16) return launch_elems<uint4>(src, ip, out, N, E, wv, total, elems, st);
  if (bytes == 8) return launch_elems<uint2>(src, ip, out, N, E, wv, total, elems, st);
  if (bytes == 4) return launch_elems<unsigned int>(src, ip, out, N, E, wv, total, elems, st);
  return launch_elems<unsigned short>(src, ip, out, N, E, wv, total, elems, st);
}
