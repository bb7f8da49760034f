// windowed_scatter_mean_kernel: scatter-mean upsample over a
// window-constrained index, the coarse -> fine move of the window modes.
//
// Replaces mpa_tpu/ops/pallas/window_attention.py::_wscatter_sum_count
// (kernel body _wscatter_kernel) and the divide of ::_wscatter_mean.
// Contract: the function of scatter_mean_kernel (scatter_mean.cu): feat
// [B,S,C] f32, idx [B,S,K] int32 -> out [B,N,C] f32, the mean of the coarse
// rows that claim each fine slot (count clamped to 1, an unclaimed slot is
// zero), and count [B,N] f32; for an idx whose row s lies in its coarse
// chunk's Morton window (window.cuh), the windowed kNN's guarantee. A claim
// from outside that window is not seen (the TPU kernel drops it too):
// ops/window.py checks the precondition with torch ops when asked to.
//
// What bounds it on the H100: bytes (feat and idx read once, out and count
// written once). Design: scatter_mean.cu's gather, with the search cut to the
// window. One warp owns one fine slot n and adds the rows that claim it, in
// ascending (s, k) order (lanes across channels, coalesced), so the sum has
// a fixed order and equals the plain version on the CPU bit for bit; the
// count is a popcount. Slot n lies in base block j = n / bn, which only the
// windows g = j - 1 and g = j contain; the chunks with those windows are
// consecutive, so the rows that can claim n are one range of at most four
// chunks of sq rows. A block of 16 warps stages the union of its slots'
// ranges through shared memory and each lane compares four staged indices
// with n per step. That is at most 4*sq*K compares per slot (4,096 at
// sq = 128, K = 8) where scatter_mean_kernel makes S*K, a cut by about
// S / (3*sq) at the model's shapes.
#include "common.cuh"

namespace {

constexpr int kTile = 8192;    // indices staged per pass: 32 KB of shared memory
constexpr int kThreads = 512;  // 16 warps, one fine slot each
constexpr int kWarps = kThreads / 32;

// Query rows [lo, hi) whose window can contain fine slot n.
__device__ __forceinline__ void claim_rows(int n, int S, int sq, int bn, int n_chunks, int& lo,
                                           int& hi) {
  const int j = n / bn;
  const int g_lo = max(j - 1, 0), g_hi = min(j, n_chunks - 2);
  const int c_lo = g_lo == 0 ? 0 : g_lo + 1;                 // first chunk with window g_lo
  const int c_hi = g_hi == n_chunks - 2 ? n_chunks : g_hi + 1;  // last chunk with window g_hi
  const int pad = sq / 2;
  lo = max(c_lo * sq - pad, 0);
  hi = min((c_hi + 1) * sq - pad, S);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
windowed_scatter_mean_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                             float* __restrict__ out, float* __restrict__ count, int S, int K,
                             int N, int C, int sq, int bn, int n_chunks) {
  __shared__ int4 tile4[kTile / 4];
  int* tile = reinterpret_cast<int*>(tile4);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kWarps;
  const int n = n0 + warp;  // warp-uniform; may be >= N
  int lo, hi, unused;
  claim_rows(n0, S, sq, bn, n_chunks, lo, unused);
  claim_rows(min(n0 + kWarps, N) - 1, S, sq, bn, n_chunks, unused, hi);
  const int e_lo = lo * K, e_hi = hi * K;
  const int* ib = idx + static_cast<size_t>(b) * S * K;
  const float* fb = feat + static_cast<size_t>(b) * S * C;

  for (int c0 = 0; c0 < C; c0 += 32 * R) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    int cnt = 0;
    for (int e0 = e_lo; e0 < e_hi; e0 += kTile) {
      const int len = min(kTile, e_hi - e0);
      const int padded = (len + 127) & ~127;  // whole int4 steps of a warp
      __syncthreads();  // the previous tile is used up
      for (int i = threadIdx.x; i < padded; i += kThreads) tile[i] = i < len ? ib[e0 + i] : -1;
      __syncthreads();
      if (n >= N) continue;
      for (int j0 = 0; j0 < padded; j0 += 128) {
        const int4 v = tile4[(j0 >> 2) + lane];
        const unsigned mine = static_cast<unsigned>(v.x == n) | (static_cast<unsigned>(v.y == n) << 1) |
                              (static_cast<unsigned>(v.z == n) << 2) |
                              (static_cast<unsigned>(v.w == n) << 3);
        unsigned hit = __ballot_sync(0xffffffffu, mine != 0u);
        while (hit != 0u) {  // claiming lanes in ascending order
          const int src = __ffs(hit) - 1;
          hit &= hit - 1u;
          unsigned bits = __shfl_sync(0xffffffffu, mine, src);
          while (bits != 0u) {  // that lane's four indices in ascending order
            const int jj = __ffs(bits) - 1;
            bits &= bits - 1u;
            const int e = e0 + j0 + 4 * src + jj;
            const float* row = fb + static_cast<size_t>(e / K) * C + c0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int c = lane + 32 * r;
              if (c0 + c < C) acc[r] = __fadd_rn(acc[r], row[c]);
            }
            ++cnt;
          }
        }
      }
    }
    if (n < N) {
      const float den = fmaxf(static_cast<float>(cnt), 1.f);
      float* orow = out + (static_cast<size_t>(b) * N + n) * C + c0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = lane + 32 * r;
        if (c0 + c < C) orow[c] = __fdiv_rn(acc[r], den);
      }
      if (c0 == 0 && lane == 0) count[static_cast<size_t>(b) * N + n] = static_cast<float>(cnt);
    }
  }
}

template <int R>
cudaError_t launch(const float* feat, const int* idx, float* out, float* count, int B, int S,
                   int K, int N, int C, int sq, int bn, int n_chunks, cudaStream_t stream) {
  dim3 grid(mpa::ceil_div(N, kWarps), B);
  windowed_scatter_mean_kernel<R><<<grid, kThreads, 0, stream>>>(feat, idx, out, count, S, K, N,
                                                                 C, sq, bn, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// feat [B,S,C] f32, idx [B,S,K] int32, out [B,N,C] f32, count [B,N] f32, all
// contiguous; the window spec (sq, bn, n_chunks) of the (S, N) pair as
// make_window_spec gives it. Requires B <= 65535, S*K < 2^31 and C >= 1
// (checked by the Python wrapper).
MPA_EXPORT int mpa_windowed_scatter_mean(const void* feat, const void* idx, void* out, void* count,
                                         int B, int S, int K, int N, int C, int sq, int bn,
                                         int n_chunks, void* stream) {
  if (B == 0 || N == 0) return cudaGetLastError();
  auto fp = static_cast<const float*>(feat);
  auto ip = static_cast<const int*>(idx);
  auto op = static_cast<float*>(out);
  auto cp = static_cast<float*>(count);
  cudaStream_t st = mpa::as_stream(stream);
  if (C <= 32) return launch<1>(fp, ip, op, cp, B, S, K, N, C, sq, bn, n_chunks, st);
  if (C <= 64) return launch<2>(fp, ip, op, cp, B, S, K, N, C, sq, bn, n_chunks, st);
  if (C <= 128) return launch<4>(fp, ip, op, cp, B, S, K, N, C, sq, bn, n_chunks, st);
  return launch<8>(fp, ip, op, cp, B, S, K, N, C, sq, bn, n_chunks, st);
}
