// scatter_mean_kernel: scatter-mean upsample, the decoder's coarse -> fine move.
//
// Replaces mpa_tpu/ops/pallas/scatter_pallas.py::_scatter_sum_count (kernel
// body _scatter_kernel) and the divide of ::scatter_mean_upsample_pallas.
// Contract: feat [B,S,C] f32, idx [B,S,K] int32 -> out [B,N,C] f32 and
// count [B,N] f32. Every coarse point s adds its row to the K fine slots
// idx[b,s,:]; count[b,n] is the number of (s,k) with idx[b,s,k] == n (a slot
// named twice by one coarse point counts twice); out[b,n] = sum /
// max(count, 1), so an unclaimed slot is zero. An index outside [0, N) claims
// no slot.
//
// What bounds it on the H100: bytes (feat and idx read once, out and count
// written once; one add per claimed row float). What costs the time here is
// the search, not the bytes: the kernel turns the scatter into a gather so
// that the sum has a fixed order. One warp owns one fine slot (b, n). The
// block stages the cloud's S*K indices through shared memory in tiles; each
// lane compares four staged indices with n per step, a ballot finds the
// claims, and the warp adds the claiming rows, lanes across channels
// (coalesced), in ascending (s, k) order. That is the order in which a
// sequential index_add_ visits them, so the result has no run-to-run
// difference and equals the plain version on the CPU bit for bit; atomicAdd
// into the slots would land in no fixed order, and the feature-space kNN
// downstream turns last bits into other neighbours. The count is an integer
// popcount, exact. At most B*N*S*K integer compares per launch (2.1e9 at the
// largest part-seg shape). The TPU's one-hot mask^T @ f matmuls, the bf16
// hi/lo split, the lane-padded count tile and the S-chunk grid answer the
// TPU's serial scatter and VMEM limit and are not carried over.
#include "common.cuh"

namespace {

constexpr int kTile = 8192;    // indices staged per pass: 32 KB of shared memory
constexpr int kThreads = 512;  // 16 warps, one fine slot each
constexpr int kWarps = kThreads / 32;

// R accumulators per lane: one pass covers 32*R channels; wider rows take
// further passes over the index list.
template <int R>
__global__ void __launch_bounds__(kThreads)
scatter_mean_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                    float* __restrict__ out, float* __restrict__ count, int S, int K, int N,
                    int C) {
  __shared__ int4 tile4[kTile / 4];
  int* tile = reinterpret_cast<int*>(tile4);
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;  // warp-uniform; may be >= N
  const int E = S * K;
  const int* ib = idx + static_cast<size_t>(b) * E;
  const float* fb = feat + static_cast<size_t>(b) * S * C;

  for (int c0 = 0; c0 < C; c0 += 32 * R) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    int cnt = 0;
    for (int e0 = 0; e0 < E; e0 += kTile) {
      const int len = min(kTile, E - e0);
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
            const int j = __ffs(bits) - 1;
            bits &= bits - 1u;
            const int e = e0 + j0 + 4 * src + j;
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
                   int K, int N, int C, cudaStream_t stream) {
  dim3 grid(mpa::ceil_div(N, kWarps), B);
  scatter_mean_kernel<R><<<grid, kThreads, 0, stream>>>(feat, idx, out, count, S, K, N, C);
  return cudaGetLastError();
}

}  // namespace

// feat [B,S,C] f32, idx [B,S,K] int32, out [B,N,C] f32, count [B,N] f32, all
// contiguous. Requires B <= 65535, S*K < 2^31 and C >= 1 (checked by the
// Python wrapper).
MPA_EXPORT int mpa_scatter_mean(const void* feat, const void* idx, void* out, void* count,
                                int B, int S, int K, int N, int C, void* stream) {
  if (B == 0 || N == 0) return cudaGetLastError();
  auto fp = static_cast<const float*>(feat);
  auto ip = static_cast<const int*>(idx);
  auto op = static_cast<float*>(out);
  auto cp = static_cast<float*>(count);
  cudaStream_t st = mpa::as_stream(stream);
  if (C <= 32) return launch<1>(fp, ip, op, cp, B, S, K, N, C, st);
  if (C <= 64) return launch<2>(fp, ip, op, cp, B, S, K, N, C, st);
  if (C <= 128) return launch<4>(fp, ip, op, cp, B, S, K, N, C, st);
  return launch<8>(fp, ip, op, cp, B, S, K, N, C, st);
}
