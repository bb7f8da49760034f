// ball_query_kernel: the sentinel stage of radius (ball) grouping.
//
// Replaces mpa_tpu/ops/pallas/ball_pallas.py::ball_query_indices_pallas
// (kernel body _ball_kernel). Contract: xyz [B,N,C] f32, new_xyz [B,S,C] f32
// and r2 -> [B,S,nsample] int32: for each centre, the nsample LOWEST-index
// base points whose squared distance is <= r2, in ascending index order, and
// the sentinel N in the slots left over. The caller backfills the sentinels
// (ops/ball_query.py). r2 is a runtime argument: the wrapper rounds
// radius * radius, taken in double, once to float32, as JAX compares
// d <= radius * radius, so any radius runs without a rebuild.
//
// Distances: knn.cu's arithmetic, the expanded form |q|^2 + |b|^2 - 2 q.b
// clamped at 0, each dot product accumulated in channel order with
// separately rounded multiplies and adds (no FMA contraction), which is what
// ops/pairwise.py::square_distance computes. So membership equals the plain
// version's even where a distance lies within a last bit of r2.
//
// What bounds it on the H100: the B*S*N distance tests, (2C + 3) float32
// operations each, on the CUDA cores; the bytes (the two clouds in, the
// indices out) are small. The TPU kernel's distance tile on the matrix unit
// and its nsample min-passes over the whole tile are not carried over: a warp
// finds its hits in index order directly. Design: one block per (cloud, group
// of WARPS centres) stages the cloud's rows and their squared norms in shared
// memory, in tiles of a bounded number of rows (a 3-channel cloud of up to
// 2048 points is one tile). One warp per centre tests 32 consecutive base
// indices at a time, lane i index j0 + i; __ballot_sync gives the in-radius
// mask and __popc of the mask below a lane gives that lane's slot, so hits
// land in ascending index order with no sort. A warp stops testing once
// nsample hits are written, the block stops staging tiles once all its warps
// have, and each warp fills its remaining slots with N.
#include "common.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int TILE_FLOATS = 8192;  // at most 32 KB of staged rows and norms

__global__ void __launch_bounds__(WARPS * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                  int* __restrict__ out, int N, int S, int C, int nsample, float r2,
                  int b_stride, int tile_n) {
  extern __shared__ float smem[];
  float* q_s = smem;                       // [WARPS][C] the block's centres
  float* b_s = q_s + WARPS * C;            // [tile_n][b_stride] base rows
  float* bn_s = b_s + tile_n * b_stride;   // [tile_n] their squared norms

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * WARPS;
  const int s = s0 + w;
  const float* xb = xyz + static_cast<size_t>(b) * N * C;
  const float* qb = new_xyz + (static_cast<size_t>(b) * S + s0) * C;
  for (int e = t; e < WARPS * C; e += blockDim.x) q_s[e] = (s0 + e / C < S) ? qb[e] : 0.f;
  __syncthreads();

  const float* q = q_s + w * C;
  float qn = __fmul_rn(q[0], q[0]);
  for (int c = 1; c < C; ++c) qn = __fadd_rn(qn, __fmul_rn(q[c], q[c]));

  // Hits found so far; warp-uniform. A warp past the last centre has none to find.
  int count = s < S ? 0 : nsample;
  int* o = out + (static_cast<size_t>(b) * S + s) * nsample;
  for (int j0 = 0; j0 < N; j0 += tile_n) {
    // Also waits until the previous tile has been consumed.
    if (!__syncthreads_or(count < nsample)) break;  // uniform: every warp is done
    const int nt = min(tile_n, N - j0);
    const float* src = xb + static_cast<size_t>(j0) * C;
    for (int e = t; e < nt * C; e += blockDim.x) {
      const int r = e / C;
      b_s[r * b_stride + (e - r * C)] = src[e];
    }
    __syncthreads();
    for (int r = t; r < nt; r += blockDim.x) {
      const float* br = b_s + r * b_stride;
      float n2 = __fmul_rn(br[0], br[0]);
      for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(br[c], br[c]));
      bn_s[r] = n2;
    }
    __syncthreads();
    for (int r0 = 0; r0 < nt && count < nsample; r0 += 32) {
      const int r = r0 + lane;
      bool in = false;
      if (r < nt) {
        const float* br = b_s + r * b_stride;
        float cross = __fmul_rn(q[0], br[0]);
        for (int c = 1; c < C; ++c) cross = __fadd_rn(cross, __fmul_rn(q[c], br[c]));
        const float d = fmaxf(__fsub_rn(__fadd_rn(qn, bn_s[r]), __fmul_rn(2.f, cross)), 0.f);
        in = d <= r2;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, in);
      const int slot = count + __popc(mask & ((1u << lane) - 1u));
      if (in && slot < nsample) o[slot] = j0 + r;
      count += __popc(mask);
    }
  }
  if (s >= S) return;
  for (int slot = min(count, nsample) + lane; slot < nsample; slot += 32) o[slot] = N;
}

}  // namespace

// xyz [B,N,C], new_xyz [B,S,C] f32 contiguous -> out [B,S,nsample] int32.
// Requires B, N, S >= 1, 1 <= C <= 256 and nsample >= 1 (checked by the Python
// wrapper); r2 is the squared radius in float32.
MPA_EXPORT int mpa_ball_query(const void* xyz, const void* new_xyz, void* out, int B, int N,
                              int S, int C, int nsample, float r2, void* stream) {
  const int b_stride = (C % 2 == 0) ? C + 1 : C;  // odd: 32 lanes on 32 banks
  int tile_n = (TILE_FLOATS / (b_stride + 1)) / 32 * 32;
  const int n_pad = mpa::ceil_div(N, 32) * 32;
  tile_n = tile_n < 32 ? 32 : (tile_n > n_pad ? n_pad : tile_n);
  const size_t smem = sizeof(float) * (static_cast<size_t>(WARPS) * C +
                                       static_cast<size_t>(tile_n) * (b_stride + 1));
  cudaError_t err = mpa::allow_smem(ball_query_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mpa::ceil_div(S, WARPS), B);
  ball_query_kernel<<<grid, WARPS * 32, smem, mpa::as_stream(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(new_xyz), static_cast<int*>(out),
      N, S, C, nsample, r2, b_stride, tile_n);
  return cudaGetLastError();
}
