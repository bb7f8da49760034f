// windowed_knn_kernel: k nearest neighbours inside each query chunk's Morton
// window.
//
// Replaces mpa_tpu/ops/pallas/window_attention.py::windowed_knn_indices
// (kernel body _wknn_kernel). Contract (ops/window.py, WindowSpec): base
// [B,N,C] f32 and query [B,S,C] f32, both Morton-ordered; the queries are
// padded by sq/2 rows at each end and cut into n_chunks + 1 padded chunks of
// sq rows; padded chunk c sees the window of base rows [g*bn, g*bn + 2*bn),
// g = clamp(c - 1, 0, n_chunks - 2). Out: for every real query its k
// smallest distances inside its chunk's window, ascending, ties to the
// lowest index, as GLOBAL int32 indices [B,S,k]; and the distances to those
// rows recomputed in direct form sum_c (q_c - b_c)^2 [B,S,k] f32, the form
// the gradient is taken of (window_attention.py:246-252).
//
// Selection distances: the expanded form |q|^2 + |b|^2 - 2 q.b, NOT clamped
// at 0 (the TPU kernel does not clamp either, unlike knn_kernel), each dot
// product accumulated in channel order with separately rounded multiplies
// and adds, no FMA; ops/window.py::windowed_knn_plain does the same
// arithmetic, so the kernel and the plain version agree bit for bit.
//
// What bounds it on the H100: the S*2bn*C cross term in f32 on the CUDA
// cores, far below a millisecond at the model's shapes; at this size the
// launch and the tile loads count as much. Design: knn_kernel's, on a window
// instead of the whole base. A block owns WARPS*QPW consecutive padded rows
// of one chunk, so all its queries share one window; it streams the window
// rows through shared memory in tiles (rows padded to an odd stride), each
// lane keeps a sorted top-k list in registers for its rows, and the warp
// merges the 32 lists. Pad rows are staged as zeros and never written. The
// TPU's one-hot window blocks and its hi/lo bf16 cross term are matrix-unit
// workarounds and are not carried over.
#include "knn_select.cuh"

namespace {

using mpa::insert;
using mpa::load_q;
using mpa::pop_min;

constexpr int WARPS = 8;

template <int KMAX, int QPW>
__global__ void __launch_bounds__(WARPS * 32)
windowed_knn_kernel(const float* __restrict__ base, const float* __restrict__ query,
                    float* __restrict__ out_d, int* __restrict__ out_i, int N, int S, int C,
                    int k, int sq, int bn, int n_chunks, int tiles_per_chunk, int b_stride,
                    int tile_n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int QB = WARPS * QPW;          // padded rows per block
  float* q_s = smem;                       // [WARPS][C][QPW], channel-major per warp
  float* b_s = q_s + QB * C;               // [tile_n][b_stride]
  float* bn_s = b_s + tile_n * b_stride;   // [tile_n] squared norms of the tile

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x / tiles_per_chunk;
  const int p0 = chunk * sq + (blockIdx.x % tiles_per_chunk) * QB;  // first padded row
  const int p_end = min(p0 + QB, (chunk + 1) * sq);
  const int pad = sq / 2;
  const int win0 = min(max(chunk - 1, 0), n_chunks - 2) * bn;
  const int W = 2 * bn;
  const float* qb = query + static_cast<size_t>(b) * S * C;
  const float* bb = base + static_cast<size_t>(b) * N * C;

  for (int e = t; e < QB * C; e += blockDim.x) {
    const int r = e / C, c = e - r * C;  // padded row p0 + r, channel c
    const int s = p0 + r - pad;
    const bool live = p0 + r < p_end && s >= 0 && s < S;
    q_s[((r / QPW) * C + c) * QPW + (r % QPW)] = live ? qb[static_cast<size_t>(s) * C + c] : 0.f;
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
  const int pw = p0 + w * QPW;  // the warp's first padded row
  const bool warp_live = pw < p_end && pw - pad < S && pw + QPW - 1 - pad >= 0;

  for (int j0 = 0; j0 < W; j0 += tile_n) {
    const int nt = min(tile_n, W - j0);
    __syncthreads();  // the previous tile has been consumed
    const float* src = bb + static_cast<size_t>(win0 + j0) * C;
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
      const float n2 = bn_s[r];
#pragma unroll
      for (int q = 0; q < QPW; ++q) {
        const float d = __fsub_rn(__fadd_rn(qn[q], n2), __fmul_rn(2.f, cross[q]));
        insert<KMAX>(bd[q], bi[q], d, win0 + j0 + r);
      }
    }
  }
  if (!warp_live) return;

#pragma unroll
  for (int q = 0; q < QPW; ++q) {
    const int s = pw + q - pad;
    if (pw + q >= p_end || s >= S) break;  // uniform across the warp
    if (s < 0) continue;                   // a front pad row
    int mine = -1;                         // lane i keeps the i-th neighbour
    for (int i = 0; i < k; ++i) {
      float v;
      int id;
      pop_min<KMAX>(bd[q], bi[q], v, id);
      if (lane == i) mine = id;
    }
    if (lane < k) {
      // Direct-form distance to the selected row, in channel order (NaN
      // where a NaN input left fewer than k candidates).
      float d = NAN;
      if (mine >= 0 && mine < N) {
        const float* br = bb + static_cast<size_t>(mine) * C;
        const float* qq = qw + q;
        float diff = __fsub_rn(qq[0], br[0]);
        d = __fmul_rn(diff, diff);
        for (int c = 1; c < C; ++c) {
          diff = __fsub_rn(qq[c * QPW], br[c]);
          d = __fadd_rn(d, __fmul_rn(diff, diff));
        }
      }
      const size_t o = (static_cast<size_t>(b) * S + s) * k + lane;
      out_d[o] = d;
      out_i[o] = mine;
    }
  }
}

template <int KMAX, int QPW>
cudaError_t launch(const float* base, const float* query, float* out_d, int* out_i, int B, int N,
                   int S, int C, int k, int sq, int bn, int n_chunks, cudaStream_t stream) {
  const int b_stride = (C % 2 == 0) ? C + 1 : C;
  int tile_n = (8192 / b_stride) / 32 * 32;  // about 32 KB of window rows
  tile_n = tile_n < 32 ? 32 : (tile_n > 1024 ? 1024 : tile_n);
  auto bytes = [&](int tn) {
    return sizeof(float) * (static_cast<size_t>(WARPS) * QPW * C +
                            static_cast<size_t>(tn) * b_stride + tn);
  };
  while (bytes(tile_n) > 227 * 1024 && tile_n > 8) tile_n /= 2;  // wide C: smaller tiles
  const size_t smem = bytes(tile_n);
  cudaError_t err = mpa::allow_smem(windowed_knn_kernel<KMAX, QPW>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_chunk = mpa::ceil_div(sq, WARPS * QPW);
  dim3 grid((n_chunks + 1) * tiles_per_chunk, B);
  windowed_knn_kernel<KMAX, QPW><<<grid, WARPS * 32, smem, stream>>>(
      base, query, out_d, out_i, N, S, C, k, sq, bn, n_chunks, tiles_per_chunk, b_stride, tile_n);
  return cudaGetLastError();
}

}  // namespace

// base [B,N,C], query [B,S,C] f32 contiguous; out_d [B,S,k] f32, out_i
// [B,S,k] int32; the window spec (sq, bn, n_chunks) as make_window_spec
// gives it: S == n_chunks * sq, N == n_chunks * bn, n_chunks >= 2. Requires
// 1 <= k <= min(32, 2*bn) and 1 <= C <= 1024 (checked by the Python wrapper).
MPA_EXPORT int mpa_windowed_knn(const void* base, const void* query, void* out_d, void* out_i,
                                int B, int N, int S, int C, int k, int sq, int bn, int n_chunks,
                                void* stream) {
  if (B == 0 || S == 0) return cudaGetLastError();
  auto bp = static_cast<const float*>(base);
  auto qp = static_cast<const float*>(query);
  auto dp = static_cast<float*>(out_d);
  auto ip = static_cast<int*>(out_i);
  cudaStream_t st = mpa::as_stream(stream);
  // As knn_kernel: four queries per warp where a distance is long enough for
  // the shared window loads to dominate, one for coordinates.
  const bool wide = C >= 16;
  if (k <= 8) return wide ? launch<8, 4>(bp, qp, dp, ip, B, N, S, C, k, sq, bn, n_chunks, st)
                          : launch<8, 1>(bp, qp, dp, ip, B, N, S, C, k, sq, bn, n_chunks, st);
  if (k <= 16) return wide ? launch<16, 4>(bp, qp, dp, ip, B, N, S, C, k, sq, bn, n_chunks, st)
                           : launch<16, 1>(bp, qp, dp, ip, B, N, S, C, k, sq, bn, n_chunks, st);
  return launch<32, 1>(bp, qp, dp, ip, B, N, S, C, k, sq, bn, n_chunks, st);
}
