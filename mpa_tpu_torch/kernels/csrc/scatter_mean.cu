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
// bf16 features give a bf16 out: the same f32 sums and divide, rounded once,
// and an f32 count (mpa_tpu/ops/scatter.py:46-51 casts the f32 mean of
// _scatter_sum_count, which upcasts the features, to the features' type).
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
template <int VEC, int DEPTH, typename T>
__global__ void __launch_bounds__(mpa::kIndexThreads, mpa::kIndexBlocks)
scatter_mean_kernel(const T* __restrict__ feat, const int* __restrict__ idx,
                    T* __restrict__ out, float* __restrict__ part, float* __restrict__ count,
                    int S, int K, int N, int C, int slots, int tile) {
  extern __shared__ int4 smem4[];
  __shared__ mpa::IndexShared sh;
  const int b = blockIdx.y, n0 = blockIdx.x * slots;
  const int E = S * K;
  const size_t slot0 = static_cast<size_t>(b) * N + n0;
  mpa::scatter_rows<VEC, DEPTH, true>(feat + static_cast<size_t>(b) * S * C,
                                      idx + static_cast<size_t>(b) * E, 0, E, K, n0,
                                      min(slots, N - n0), C, tile, out + slot0 * C,
                                      part == nullptr ? nullptr : part + slot0 * C,
                                      count + slot0, sh, smem4);
}

template <typename T>
cudaError_t launch(const void* feat, const void* idx, void* out, float* part, float* count, int B,
                   int S, int K, int N, int C, int slots, int vec, cudaStream_t st) {
  const int tile = mpa::index_tile(S * K);
  const bool deep = mpa::index_depth(static_cast<long long>(S) * K, N) == 8;
  auto kernel = scatter_mean_kernel<1, 4, T>;
  if (vec == 4) kernel = deep ? scatter_mean_kernel<4, 8, T> : scatter_mean_kernel<4, 4, T>;
  if constexpr (std::is_same<T, mpa::bf16>::value) {
    if (vec == 8) kernel = deep ? scatter_mean_kernel<8, 8, T> : scatter_mean_kernel<8, 4, T>;
  }
  dim3 grid(mpa::ceil_div(N, slots), B);
  kernel<<<grid, mpa::kIndexThreads, mpa::index_smem(tile), st>>>(
      static_cast<const T*>(feat), static_cast<const int*>(idx), static_cast<T*>(out), part,
      count, S, K, N, C, slots, tile);
  return cudaGetLastError();
}

}  // namespace

// feat [B,S,C], idx [B,S,K] int32, out [B,N,C], count [B,N] f32, all
// contiguous; feat and out f32 (bf16 == 0) or bf16 (bf16 == 1). part: for
// bf16 with S*K > kMaxTile (more than one pass), an f32 scratch [B,N,C] for
// the sums of the passes before the last, else null. Requires B <= 65535,
// S*K < 2^31 and C >= 1 (checked by the Python wrapper). slots: a block's
// range of slots, 1..256; vec: channels a lane, 4, or 8 for bf16 (C a
// multiple of it, feat and out aligned to that many values), or 1
// (ops/scatter.py::scatter_mean_form picks them); any other is refused with
// cudaErrorInvalidValue.
MPA_EXPORT int mpa_scatter_mean(const void* feat, const void* idx, void* out, void* part,
                                void* count, int B, int S, int K, int N, int C, int slots,
                                int vec, int bf16, void* stream) {
  if (B == 0 || N == 0) return cudaGetLastError();
  const size_t align = (bf16 ? 2 : sizeof(float)) * vec;
  const auto misaligned = [align](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % align != 0;
  };
  const bool wide = vec == 4 || (vec == 8 && bf16);
  if (slots < 1 || slots > mpa::kMaxSlots ||
      !(vec == 1 || (wide && C % vec == 0 && !misaligned(feat) && !misaligned(out))) ||
      (bf16 && static_cast<long long>(S) * K > mpa::kMaxTile && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = mpa::as_stream(stream);
  if (bf16)
    return launch<mpa::bf16>(feat, idx, out, static_cast<float*>(part),
                             static_cast<float*>(count), B, S, K, N, C, slots, vec, st);
  return launch<float>(feat, idx, out, nullptr, static_cast<float*>(count), B, S, K, N, C, slots,
                       vec, st);
}
