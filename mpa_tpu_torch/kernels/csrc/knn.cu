// knn_kernel: exact k-nearest-neighbour selection.
//
// Replaces mpa_tpu/ops/pallas/knn_pallas.py::knn_indices_pallas (kernel body
// _knn_kernel, cross term _cross_matmul). Contract: base [B,N,C] f32,
// query [B,S,C] f32 -> the k smallest squared distances [B,S,k] f32 and their
// indices [B,S,k] int32, ascending, ties to the lowest index (lax.top_k's
// order). No [B,S,N] distance matrix is written to device memory.
//
// Distances: the expanded form |q|^2 + |b|^2 - 2 q.b, clamped at 0, each dot
// product accumulated in channel order with separately rounded multiplies
// and adds (no FMA contraction). ops/pairwise.py::square_distance does the
// same arithmetic, so kernel and plain version agree bit for bit and select
// the same neighbours even where two distances differ in their last bit. The
// TPU's hi/lo bf16 split of the cross term is a matrix-unit workaround and is
// not carried over; the tensor cores offer no exact f32 product either.
//
// What bounds it on the H100: the S*N*C cross term in f32 on the CUDA cores,
// and the shared-memory loads that feed it. Design: each warp owns QPW
// queries. A block streams the base through shared memory in tiles, rows
// padded to an odd stride so the 32 lanes, each on its own base point, read
// distinct banks. A lane computes whole distances from its base points
// (lane, lane+32, ...) to the warp's QPW queries, so every dot product keeps
// its channel order while one base value loaded feeds QPW multiply-adds; the
// queries sit in shared memory channel-major, so one broadcast float4 load
// gives a channel of all four. Each lane keeps, per query, a sorted
// (dist, idx) list of KMAX entries in registers; candidates reach a lane in
// increasing index, so a strict compare keeps ties in index order. At the end
// the warp merges its 32 lists per query: k rounds of a lexicographic
// (dist, idx) warp minimum over the list heads, the winning lane popping its
// head.
#include "knn_select.cuh"

namespace {

using mpa::insert;
using mpa::load_q;
using mpa::pop_min;

constexpr int WARPS = 8;

template <int KMAX, int QPW>
__global__ void __launch_bounds__(WARPS * 32)
knn_kernel(const float* __restrict__ base, const float* __restrict__ query,
           float* __restrict__ out_d, int* __restrict__ out_i,
           int N, int S, int C, int k, int b_stride, int tile_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int QB = WARPS * QPW;          // queries per block
  float* q_s = smem;                       // [WARPS][C][QPW], channel-major per warp
  float* b_s = q_s + QB * C;               // [tile_n][b_stride]
  float* bn_s = b_s + tile_n * b_stride;   // [tile_n] squared norms of the tile

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * QB;
  const float* qb = query + static_cast<size_t>(b) * S * C;
  const float* bb = base + static_cast<size_t>(b) * N * C;

  for (int e = t; e < QB * C; e += blockDim.x) {
    const int r = e / C, c = e - r * C;  // query r of the block, channel c
    const float v = (s0 + r < S) ? qb[static_cast<size_t>(s0) * C + e] : 0.f;
    q_s[((r / QPW) * C + c) * QPW + (r % QPW)] = v;
  }
  __syncthreads();

  const float* qw = q_s + w * C * QPW;
  float qn[QPW];
  {
    float qv[QPW];
    load_q<QPW>(qw, qv);
#pragma unroll
    for (int q = 0; q < QPW; ++q) qn[q] = __fmul_rn(qv[q], qv[q]);
    for (int c = 1; c < C; ++c) {
      load_q<QPW>(qw + c * QPW, qv);
#pragma unroll
      for (int q = 0; q < QPW; ++q) qn[q] = __fadd_rn(qn[q], __fmul_rn(qv[q], qv[q]));
    }
  }

  float bd[QPW][KMAX];
  int bi[QPW][KMAX];
#pragma unroll
  for (int q = 0; q < QPW; ++q) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      bd[q][i] = INFINITY;
      bi[q][i] = INT_MAX;
    }
  }
  const int sw = s0 + w * QPW;  // the warp's first query
  const bool warp_live = sw < S;

  for (int j0 = 0; j0 < N; j0 += tile_n) {
    const int nt = min(tile_n, N - j0);
    __syncthreads();  // the previous tile has been consumed
    const float* src = bb + static_cast<size_t>(j0) * C;
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
    if (!warp_live) continue;
    for (int r = lane; r < nt; r += 32) {
      const float* br = b_s + r * b_stride;
      float qv[QPW], cross[QPW];
      float bv = br[0];
      load_q<QPW>(qw, qv);
#pragma unroll
      for (int q = 0; q < QPW; ++q) cross[q] = __fmul_rn(qv[q], bv);
      for (int c = 1; c < C; ++c) {
        bv = br[c];
        load_q<QPW>(qw + c * QPW, qv);
#pragma unroll
        for (int q = 0; q < QPW; ++q) cross[q] = __fadd_rn(cross[q], __fmul_rn(qv[q], bv));
      }
      const float bn = bn_s[r];
#pragma unroll
      for (int q = 0; q < QPW; ++q) {
        const float d = fmaxf(__fsub_rn(__fadd_rn(qn[q], bn), __fmul_rn(2.f, cross[q])), 0.f);
        insert<KMAX>(bd[q], bi[q], d, j0 + r);
      }
    }
  }
  if (!warp_live) return;

  // Merge the 32 lane lists of each query: each round the lexicographic
  // minimum of the heads wins, and its lane (base indices are unique to a
  // lane) pops it.
#pragma unroll
  for (int q = 0; q < QPW; ++q) {
    const int s = sw + q;
    if (s >= S) break;  // uniform across the warp
    const size_t o = (static_cast<size_t>(b) * S + s) * k;
    for (int i = 0; i < k; ++i) {
      float v;
      int id;
      pop_min<KMAX>(bd[q], bi[q], v, id);
      if (lane == 0) {
        out_d[o + i] = v;
        out_i[o + i] = id;
      }
    }
  }
}

template <int KMAX, int QPW>
cudaError_t launch(const float* base, const float* query, float* out_d, int* out_i,
                   int B, int N, int S, int C, int k, cudaStream_t stream) {
  const int b_stride = (C % 2 == 0) ? C + 1 : C;
  int tile_n = (8192 / b_stride) / 32 * 32;  // about 32 KB of base rows
  tile_n = tile_n < 32 ? 32 : (tile_n > 1024 ? 1024 : tile_n);
  auto bytes = [&](int tn) {
    return sizeof(float) * (static_cast<size_t>(WARPS) * QPW * C +
                            static_cast<size_t>(tn) * b_stride + tn);
  };
  while (bytes(tile_n) > 227 * 1024 && tile_n > 8) tile_n /= 2;  // wide C: smaller tiles
  const size_t smem = bytes(tile_n);
  cudaError_t err = mpa::allow_smem(knn_kernel<KMAX, QPW>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(mpa::ceil_div(S, WARPS * QPW), B);
  knn_kernel<KMAX, QPW><<<grid, WARPS * 32, smem, stream>>>(base, query, out_d, out_i, N, S,
                                                            C, k, b_stride, tile_n);
  return cudaGetLastError();
}

}  // namespace

// base [B,N,C], query [B,S,C] f32 contiguous; out_d [B,S,k] f32, out_i [B,S,k]
// int32. Requires 1 <= k <= min(64, N) and 1 <= C <= 1024 (checked by the
// Python wrapper).
MPA_EXPORT int mpa_knn(const void* base, const void* query, void* out_d, void* out_i,
                       int B, int N, int S, int C, int k, void* stream) {
  auto bp = static_cast<const float*>(base);
  auto qp = static_cast<const float*>(query);
  auto dp = static_cast<float*>(out_d);
  auto ip = static_cast<int*>(out_i);
  cudaStream_t st = mpa::as_stream(stream);
  // Four queries per warp where a distance is long enough (C >= 16) for the
  // shared base loads to dominate, and while the K-lists fit in registers.
  // For coordinates (C = 3) the K-list insertions dominate, and one query
  // per warp keeps four times as many warps in flight (measured on H100).
  const bool wide = C >= 16;
  if (k <= 8) return wide ? launch<8, 4>(bp, qp, dp, ip, B, N, S, C, k, st)
                          : launch<8, 1>(bp, qp, dp, ip, B, N, S, C, k, st);
  if (k <= 16) return wide ? launch<16, 4>(bp, qp, dp, ip, B, N, S, C, k, st)
                           : launch<16, 1>(bp, qp, dp, ip, B, N, S, C, k, st);
  if (k <= 32) return launch<32, 1>(bp, qp, dp, ip, B, N, S, C, k, st);
  return launch<64, 1>(bp, qp, dp, ip, B, N, S, C, k, st);
}
