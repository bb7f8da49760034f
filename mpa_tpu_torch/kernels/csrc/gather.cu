// gather_rows_kernel: batched row gather, out[b, e, :] = src[b, idx[b, e], :].
//
// Replaces mpa_tpu/ops/pallas/gather_pallas.py::loop_gather_rows (kernel body
// _loop_gather_kernel; its batch-grid variant _loop_gather_kernel_bg has the
// same semantics). Contract: src [B,N,W] f32, idx [B,E] int32 in [0, N) ->
// out [B,E,W] f32. Forward only.
//
// What bounds it on the H100: bytes. It reads E rows of W floats and writes
// as many, so the bound is 2*B*E*W*4 bytes over the memory rate. Design: a
// 2-D grid over (batch, flattened (row, column)); neighbouring threads copy
// neighbouring columns of a row, as float4 when W % 4 == 0 and both pointers
// are 16-byte aligned, so every warp's loads and stores are coalesced. The
// TPU's scalar-prefetch row loop is a TPU layout and is not carried over.
#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                                   T* __restrict__ out, int N, int E, int W) {
  const int b = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(E) * W) return;
  const int e = static_cast<int>(i / W);
  const int w = static_cast<int>(i - static_cast<long long>(e) * W);
  const int row = __ldg(idx + static_cast<size_t>(b) * E + e);
  out[(static_cast<size_t>(b) * E + e) * W + w] =
      src[(static_cast<size_t>(b) * N + row) * W + w];
}

template <typename T>
cudaError_t launch(const T* src, const int* idx, T* out, int B, int N, int E, int W,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long work = static_cast<long long>(E) * W;
  dim3 grid(static_cast<unsigned>((work + threads - 1) / threads), B);
  gather_rows_kernel<T><<<grid, threads, 0, stream>>>(src, idx, out, N, E, W);
  return cudaGetLastError();
}

}  // namespace

// src [B,N,W] f32, idx [B,E] int32, out [B,E,W] f32, all contiguous.
MPA_EXPORT int mpa_gather_rows(const void* src, const void* idx, void* out, int B, int N,
                               int E, int W, void* stream) {
  cudaStream_t st = mpa::as_stream(stream);
  const auto ip = static_cast<const int*>(idx);
  const bool vec = (W % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  if (vec)
    return launch<float4>(static_cast<const float4*>(src), ip, static_cast<float4*>(out), B,
                          N, E, W / 4, st);
  return launch<float>(static_cast<const float*>(src), ip, static_cast<float*>(out), B, N, E,
                       W, st);
}
