// windowed_scatter_mean_kernel: scatter-mean upsample over a
// window-constrained index, the coarse -> fine move of the window modes.
//
// Replaces mpa_tpu/ops/pallas/window_attention.py::_wscatter_sum_count
// (kernel body _wscatter_kernel) and the divide of ::_wscatter_mean.
// Contract: the function of scatter_mean_kernel (scatter_mean.cu): feat
// [B,S,C] f32, idx [B,S,K] int32 -> out [B,N,C] f32, the mean of the coarse
// rows that claim each fine slot (count clamped to 1, an unclaimed slot is
// zero), and count [B,N] f32 (bf16 feat gives a bf16 out: the same f32 sums
// and divide, rounded once, as window_attention.py:581 widens the features
// and windowed_scatter_mean casts the f32 mean back, :674); for an idx
// whose row s lies in its coarse
// chunk's Morton window (window.cuh), the windowed kNN's guarantee. A claim
// from outside the rows that can claim a block's slots is not seen (the TPU
// kernel drops it too): ops/window.py checks the precondition with torch ops
// when asked to.
//
// What bounds it on the H100: bytes (feat and idx read once, out and count
// written once). Design: scatter_mean_kernel's inverse-index body
// (scatter_index.cuh, the mean epilogue), with each block's claim range cut
// from the cloud's S*K indices to the rows whose windows can hold its slots
// (mpa::claim_rows): at most three chunks of sq rows for slots in one base
// block, so a block at the model's shapes stages one pass of at most 3*sq*K
// indices, and each index is read by about 2*bn / slots blocks, not by every
// block of the cloud. The sum of each slot is taken in ascending (s, k)
// order, as the plain version's, bit for bit.
#include "scatter_index.cuh"
#include "window.cuh"

namespace {

// Grid (ceil(N / slots), B); dynamic shared memory: mpa::index_smem(tile).
template <int VEC, int DEPTH, typename T>
__global__ void __launch_bounds__(mpa::kIndexThreads, mpa::kIndexBlocks)
windowed_scatter_mean_kernel(const T* __restrict__ feat, const int* __restrict__ idx,
                             T* __restrict__ out, float* __restrict__ part,
                             float* __restrict__ count, int S, int K, int N, int C, int slots,
                             int tile, int sq, int bn, int n_chunks) {
  extern __shared__ int4 smem4[];
  __shared__ mpa::IndexShared sh;
  const int b = blockIdx.y, n0 = blockIdx.x * slots;
  const int nr = min(slots, N - n0);
  int lo, hi, unused;
  mpa::claim_rows(n0, S, sq, bn, n_chunks, lo, unused);
  mpa::claim_rows(n0 + nr - 1, S, sq, bn, n_chunks, unused, hi);
  const int e_lo = lo * K, e_hi = hi * K;
  const size_t slot0 = static_cast<size_t>(b) * N + n0;
  mpa::scatter_rows<VEC, DEPTH, true>(feat + static_cast<size_t>(b) * S * C,
                                      idx + static_cast<size_t>(b) * S * K, e_lo, e_hi, K, n0,
                                      nr, C, tile, out + slot0 * C,
                                      part == nullptr ? nullptr : part + slot0 * C,
                                      count + slot0, sh, smem4);
}

template <typename T>
cudaError_t launch(const void* feat, const void* idx, void* out, float* part, float* count, int B,
                   int S, int K, int N, int C, int slots, int vec, int sq, int bn, int n_chunks,
                   cudaStream_t st) {
  const int tile = mpa::index_tile(S * K);
  const bool deep = mpa::index_depth(static_cast<long long>(S) * K, N) == 8;
  auto kernel = windowed_scatter_mean_kernel<1, 4, T>;
  if (vec == 4)
    kernel = deep ? windowed_scatter_mean_kernel<4, 8, T> : windowed_scatter_mean_kernel<4, 4, T>;
  if constexpr (std::is_same<T, mpa::bf16>::value) {
    if (vec == 8)
      kernel =
          deep ? windowed_scatter_mean_kernel<8, 8, T> : windowed_scatter_mean_kernel<8, 4, T>;
  }
  dim3 grid(mpa::ceil_div(N, slots), B);
  kernel<<<grid, mpa::kIndexThreads, mpa::index_smem(tile), st>>>(
      static_cast<const T*>(feat), static_cast<const int*>(idx), static_cast<T*>(out), part,
      count, S, K, N, C, slots, tile, sq, bn, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// feat [B,S,C], idx [B,S,K] int32, out [B,N,C], count [B,N] f32, all
// contiguous; feat and out f32 (bf16 == 0) or bf16 (bf16 == 1); part as
// mpa_scatter_mean takes it (an f32 scratch [B,N,C] for bf16 with S*K >
// kMaxTile, else null); the window spec (sq, bn, n_chunks) of the (S, N)
// pair as make_window_spec gives it. Requires B <= 65535, S*K < 2^31 and
// C >= 1 (checked by the Python wrapper). slots and vec as mpa_scatter_mean
// takes them (ops/window.py::windowed_scatter_mean_cuda picks both with
// windowed_scatter_mean_form); any other is refused with
// cudaErrorInvalidValue.
MPA_EXPORT int mpa_windowed_scatter_mean(const void* feat, const void* idx, void* out, void* part,
                                         void* count, int B, int S, int K, int N, int C, int slots,
                                         int vec, int sq, int bn, int n_chunks, int bf16,
                                         void* stream) {
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
                             static_cast<float*>(count), B, S, K, N, C, slots, vec, sq, bn,
                             n_chunks, st);
  return launch<float>(feat, idx, out, nullptr, static_cast<float*>(count), B, S, K, N, C, slots,
                       vec, sq, bn, n_chunks, st);
}
