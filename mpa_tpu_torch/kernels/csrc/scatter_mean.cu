// scatter_mean_kernel: scatter-mean upsample, the decoder's coarse -> fine move.
//
// Replaces mpa_tpu/ops/pallas/scatter_pallas.py::_scatter_sum_count (kernel
// body _scatter_kernel) and the divide of ::scatter_mean_upsample_pallas.
// Contract: feat [B,S,C] f32, idx [B,S,K] int32 -> out [B,N,C] f32 and
// count [B,N] f32. Every coarse point s adds its row to the K fine slots
// idx[b,s,:]; count[b,n] is the number of (s,k) with idx[b,s,k] == n (a slot
// named twice by one coarse point counts twice); out[b,n] = sum /
// max(count, 1), so an unclaimed slot is zero. An index outside [0, N) claims
// no slot. Each slot's sum is taken in ascending (s, k) order from 0, the
// order in which a sequential index_add_ visits the claims, so the result has
// no run-to-run difference and equals the plain version on the CPU bit for
// bit; atomicAdd into the slots would land in no fixed order, and the
// feature-space kNN downstream turns last bits into other neighbours.
//
// What bounds it on the H100: bytes (feat and idx read once, out and count
// written once; one add per claimed row float). Design: the inverse-index
// body of scatter_index.cuh with the mean epilogue: a block owns a range of
// `slots` consecutive slots of one cloud, stages the cloud's S*K indices in
// passes, lists each slot's claiming rows in ascending (s, k) order in
// shared memory, and adds them in that order, G lanes a slot: one launch,
// about S*K compares a block rather than a slot, no float atomics. The
// TPU's one-hot mask^T @ f matmuls, the bf16 hi/lo split and the
// lane-padded count tile answer the TPU's serial scatter and VMEM limit and
// are not carried over.
#include "scatter_index.cuh"

namespace {

// Grid (ceil(N / slots), B); dynamic shared memory: mpa::index_smem(tile).
template <int VEC, int DEPTH>
__global__ void __launch_bounds__(mpa::kIndexThreads, mpa::kIndexBlocks)
scatter_mean_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                    float* __restrict__ out, float* __restrict__ count, int S, int K, int N,
                    int C, int slots, int tile) {
  extern __shared__ int4 smem4[];
  __shared__ mpa::IndexShared sh;
  const int b = blockIdx.y, n0 = blockIdx.x * slots;
  const int E = S * K;
  const size_t slot0 = static_cast<size_t>(b) * N + n0;
  mpa::scatter_rows<VEC, DEPTH, true>(feat + static_cast<size_t>(b) * S * C,
                                      idx + static_cast<size_t>(b) * E, 0, E, K, n0,
                                      min(slots, N - n0), C, tile, out + slot0 * C,
                                      count + slot0, sh, smem4);
}

}  // namespace

// feat [B,S,C] f32, idx [B,S,K] int32, out [B,N,C] f32, count [B,N] f32, all
// contiguous. Requires B <= 65535, S*K < 2^31 and C >= 1 (checked by the
// Python wrapper). slots: a block's range of slots, 1..256; vec: channels a
// lane, 4 (C % 4 == 0, feat and out 16-byte aligned) or 1
// (ops/scatter.py::scatter_mean_form picks both); any other is refused with
// cudaErrorInvalidValue.
MPA_EXPORT int mpa_scatter_mean(const void* feat, const void* idx, void* out, void* count,
                                int B, int S, int K, int N, int C, int slots, int vec,
                                void* stream) {
  if (B == 0 || N == 0) return cudaGetLastError();
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (slots < 1 || slots > mpa::kMaxSlots ||
      !(vec == 1 || (vec == 4 && C % 4 == 0 && !misaligned(feat) && !misaligned(out))))
    return cudaErrorInvalidValue;
  const int tile = mpa::index_tile(S * K);
  auto kernel = scatter_mean_kernel<1, 4>;
  if (vec == 4) {
    const bool deep = mpa::index_depth(static_cast<long long>(S) * K, N) == 8;
    kernel = deep ? scatter_mean_kernel<4, 8> : scatter_mean_kernel<4, 4>;
  }
  dim3 grid(mpa::ceil_div(N, slots), B);
  kernel<<<grid, mpa::kIndexThreads, mpa::index_smem(tile), mpa::as_stream(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int*>(idx), static_cast<float*>(out),
      static_cast<float*>(count), S, K, N, C, slots, tile);
  return cudaGetLastError();
}
