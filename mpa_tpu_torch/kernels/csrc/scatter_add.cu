// scatter_add_rows_kernel: batched row scatter-add,
// out[b, idx[b, e], :] += grads[b, e, :], the gradient of the row gather.
//
// Replaces two TPU kernels that compute one function, the VJP of
// mpa_tpu/ops/pallas/gather_pallas.py::gather_neighbors:
// ::scatter_add_rmw (kernel body _rmw_scatter_kernel, N >= 4096, a VMEM
// read-modify-write accumulator) and ::scatter_add_pallas (kernel body
// _scatter_add_kernel, a one-hot MXU matmul). Contract: grads [B,E,W] f32,
// idx [B,E] int32 -> out [B,N,W] f32, zero where no edge lands; targets
// outside [0, N) are dropped, as scatter_add_rmw drops its padded sentinels.
//
// What bounds it on the H100: bytes. It reads E rows of W floats and writes
// the N-row output once (plus the zeroing pass over it). Design: the entry
// zeroes the output with cudaMemsetAsync on the caller's stream, then a 2-D
// grid over (batch, flattened (edge, column)) adds each gradient float into
// its target with atomicAdd; neighbouring threads touch neighbouring columns
// of one row, so loads and the atomic reductions are coalesced. Sums of
// edges that share a target land in no fixed order, so the result can
// differ from a sequential sum in the last bits. The TPU's one-hot matmul and
// VMEM accumulator are TPU workarounds and are not carried over.
#include "common.cuh"

namespace {

__global__ void scatter_add_rows_kernel(const float* __restrict__ grads,
                                        const int* __restrict__ idx, float* __restrict__ out,
                                        int N, int E, int W) {
  const int b = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(E) * W) return;
  const int e = static_cast<int>(i / W);
  const int w = static_cast<int>(i - static_cast<long long>(e) * W);
  const int row = __ldg(idx + static_cast<size_t>(b) * E + e);
  if (row < 0 || row >= N) return;  // dropped, as in scatter_add_rmw
  atomicAdd(out + (static_cast<size_t>(b) * N + row) * W + w,
            grads[(static_cast<size_t>(b) * E + e) * W + w]);
}

}  // namespace

// grads [B,E,W] f32, idx [B,E] int32, out [B,N,W] f32, all contiguous. The
// output is zeroed here, on the same stream, before the adds.
MPA_EXPORT int mpa_scatter_add_rows(const void* grads, const void* idx, void* out, int B, int N,
                                    int E, int W, void* stream) {
  cudaStream_t st = mpa::as_stream(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(B) * N * W, st);
  if (err != cudaSuccess) return err;
  const long long work = static_cast<long long>(E) * W;
  if (B == 0 || work == 0) return cudaGetLastError();
  const int threads = 256;
  dim3 grid(static_cast<unsigned>((work + threads - 1) / threads), B);
  scatter_add_rows_kernel<<<grid, threads, 0, st>>>(static_cast<const float*>(grads),
                                                    static_cast<const int*>(idx),
                                                    static_cast<float*>(out), N, E, W);
  return cudaGetLastError();
}
