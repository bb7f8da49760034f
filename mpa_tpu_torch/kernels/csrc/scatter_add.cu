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
// Each target's sum is taken in ascending e from 0, the order of
// scatter_add_rmw's sequential loop and of a sequential index_add_, so the
// result equals the plain version on the CPU bit for bit. bf16 grads give a
// bf16 out: the same f32 sums, rounded once (scatter_add_rmw upcasts the
// gradient rows and the gather's VJP casts its f32 result back,
// gather_pallas.py:202,332).
//
// What bounds it on the H100: bytes (grads and idx read once, the N-row
// output written once). Design: the inverse-index body of scatter_index.cuh
// with one claim a source row (K = 1, edge e brings row e) and the sum
// epilogue: a block owns `slots` consecutive target rows of one cloud,
// stages the cloud's E indices in passes, lists each row's edges in
// ascending e in shared memory and adds their gradient rows in that order,
// G lanes a row (vec channels a lane: float4, float2 for even widths such
// as repsurf's 10 normal channels, or one float; eight bf16 as one 16-byte
// load). Every output row is
// written once, zero where no edge lands: no memset ahead of the adds, and
// no float atomics, which would sum in no fixed order. The TPU's one-hot matmul and
// VMEM accumulator are TPU workarounds and are not carried over.
#include "scatter_index.cuh"

namespace {

// Grid (ceil(N / slots), B); dynamic shared memory: mpa::index_smem(tile).
template <int VEC, int DEPTH, typename T>
__global__ void __launch_bounds__(mpa::kIndexThreads, mpa::kIndexBlocks)
scatter_add_rows_kernel(const T* __restrict__ grads, const int* __restrict__ idx,
                        T* __restrict__ out, float* __restrict__ part, int N, int E, int W,
                        int slots, int tile) {
  extern __shared__ int4 smem4[];
  __shared__ mpa::IndexShared sh;
  const int b = blockIdx.y, n0 = blockIdx.x * slots;
  const size_t e0 = static_cast<size_t>(b) * E;
  const size_t slot0 = (static_cast<size_t>(b) * N + n0) * W;
  mpa::scatter_rows<VEC, DEPTH, false>(grads + e0 * W, idx + e0, 0, E, 1, n0,
                                       min(slots, N - n0), W, tile, out + slot0,
                                       part == nullptr ? nullptr : part + slot0, nullptr, sh,
                                       smem4);
}

template <typename T>
cudaError_t launch(const void* grads, const void* idx, void* out, float* part, int B, int N,
                   int E, int W, int slots, int vec, cudaStream_t st) {
  const int tile = mpa::index_tile(E);
  const bool deep = mpa::index_depth(E, N) == 8;
  auto kernel = vec == 2 ? scatter_add_rows_kernel<2, 4, T> : scatter_add_rows_kernel<1, 4, T>;
  if (vec == 4) kernel = deep ? scatter_add_rows_kernel<4, 8, T> : scatter_add_rows_kernel<4, 4, T>;
  if constexpr (std::is_same<T, mpa::bf16>::value) {
    if (vec == 8)
      kernel = deep ? scatter_add_rows_kernel<8, 8, T> : scatter_add_rows_kernel<8, 4, T>;
  }
  dim3 grid(mpa::ceil_div(N, slots), B);
  kernel<<<grid, mpa::kIndexThreads, mpa::index_smem(tile), st>>>(
      static_cast<const T*>(grads), static_cast<const int*>(idx), static_cast<T*>(out), part, N,
      E, W, slots, tile);
  return cudaGetLastError();
}

}  // namespace

// grads [B,E,W], idx [B,E] int32, out [B,N,W], all contiguous; grads and out
// f32 (bf16 == 0) or bf16 (bf16 == 1). part: for bf16 with E > kMaxTile (more
// than one pass), an f32 scratch [B,N,W] for the sums of the passes before
// the last, else null. Requires B <= 65535 and W >= 1 (checked by the
// Python wrapper). slots: a block's range of target rows, 1..256; vec:
// channels a lane, 8 (bf16 only), 4 or 2 (W a multiple of it, grads and out
// aligned to vec values) or 1 (ops/gather.py::scatter_add_form picks them);
// any other is refused with cudaErrorInvalidValue.
MPA_EXPORT int mpa_scatter_add_rows(const void* grads, const void* idx, void* out, void* part,
                                    int B, int N, int E, int W, int slots, int vec, int bf16,
                                    void* stream) {
  if (B == 0 || N == 0) return cudaGetLastError();
  const size_t elem = bf16 ? 2 : sizeof(float);
  const auto aligned = [vec, elem](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (elem * vec) == 0;
  };
  if (slots < 1 || slots > mpa::kMaxSlots ||
      !(vec == 1 || vec == 2 || vec == 4 || (vec == 8 && bf16)) || W % vec != 0 ||
      !aligned(grads) || !aligned(out) || (bf16 && E > mpa::kMaxTile && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = mpa::as_stream(stream);
  if (bf16)
    return launch<mpa::bf16>(grads, idx, out, static_cast<float*>(part), B, N, E, W, slots, vec,
                             st);
  return launch<float>(grads, idx, out, nullptr, B, N, E, W, slots, vec, st);
}
