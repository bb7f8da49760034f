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
// not carried over; the tensor cores offer no exact f32 product either, so
// the ceiling is the f32 rate without FMA, half the 67 TFLOP/s of the bound.
//
// Design (the streaming form and the selection in knn_search.cuh and
// knn_topk.cuh, shared with windowed_knn_kernel). The selection keeps one
// sorted list of k per query in shared memory, its k-th pair the query's
// threshold: a distance is queued only if it comes before that pair in
// (dist, idx) order, and a group of lanes merges the queue into the list
// by rank after each step of base points, so nearly every candidate costs
// one compare once the list has filled. On the first step, whose list is
// empty, a candidate is queued only if it is no later than the k-th
// smallest of the 16 lane minima, a bound on the step's k-th best. Two
// forms compute the distances:
// - resident (C <= 8: the spatial kNNs and the umbrella's): the block stages
//   the whole cloud channel-major in shared memory with its norms, once;
//   each warp owns 2 queries (16 lanes a query, 16 base points a lane) and
//   walks the cloud 256 points a step with no block barrier, merging once
//   a step (steps of 64 points merged four times as often and measured
//   slower).
// - streaming (feature kNNs, and C <= 8 where the cloud outgrows 96 KB): a
//   block owns 64 queries (16 where that gives too few blocks or C > 128),
//   staged channel-major (above 128 channels streamed with the base); the
//   base streams through shared memory in tiles of 64 points and chunks of
//   32 channels, fetched into registers one chunk ahead; each thread keeps
//   a 4 x 4 micro-tile of dot products, two float4 loads feeding 16
//   multiplies and 16 adds per channel, each dot product still summed in
//   channel order. The base norms come from a small kernel ahead of it
//   (knn_kernel_norms).
//
// What bounds it on the H100: the B*S*N*(2C+3) distance operations in f32 on
// the CUDA cores, at best half the card's FMA peak without FMA. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (profile_port.py --kernels, the sum over
// a request's launches; PERF.md has the readings): about half the time of
// the design before it (per-lane lists of k in registers, one base point a
// lane) on markov_partseg's 22 launches, three fifths on markov_cls's 11,
// under a third on repsurf's umbrella kNN; the offers and merges are still
// a fifth to a third of its time.
#include "knn_search.cuh"

namespace {

using namespace mpa::knn;
using mpa::Sel;
using mpa::offer_step;

// -- the resident form: C <= 8, the whole cloud in shared memory -------------
//
// Each warp owns 2 queries (16 lanes each) and walks the staged cloud with
// no block barrier, RES_STEP points a step: lane l takes the float4 groups
// j0 + 64 r + 4 l, r < RES_STEP / 64, so a queue is merged once a step.
constexpr int RES_STEP = 256;

__global__ void __launch_bounds__(THREADS)
knn_kernel_resident(const float* __restrict__ base, const float* __restrict__ query,
                    float* __restrict__ out_d, int* __restrict__ out_i, int N, int S, int C,
                    int k, int nps) {
  constexpr int QT = 16;
  constexpr int R = RES_STEP / 64;
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);  // [C][nps] channel-major cloud
  float* bn_s = b_s + C * nps;                    // [nps] |b|^2
  const Sel sel(reinterpret_cast<char*>(bn_s + nps), QT, k, RES_STEP);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int tx = lane & 15, grp = lane >> 4;
  const int b = blockIdx.y;
  const int ql = 2 * w + grp, s = blockIdx.x * QT + ql;
  const float* bb = base + static_cast<size_t>(b) * N * C;

  for (int e = t; e < N * C; e += THREADS) {
    const int r = e / C;
    b_s[(e - r * C) * nps + r] = bb[e];
  }
  for (int r = N + t; r < nps; r += THREADS) {
    for (int c = 0; c < C; ++c) b_s[c * nps + r] = 0.f;
  }
  sel.init(ql, tx, 16);
  float qr[C_SMALL];
  float qn = 0.f;
  if (s < S) {
    const float* q = query + (static_cast<size_t>(b) * S + s) * C;
#pragma unroll
    for (int c = 0; c < C_SMALL; ++c) {
      if (c < C) {
        qr[c] = q[c];
        qn = c == 0 ? __fmul_rn(qr[c], qr[c]) : __fadd_rn(qn, __fmul_rn(qr[c], qr[c]));
      }
    }
  }
  __syncthreads();
  for (int r = t; r < nps; r += THREADS) {
    float n2 = __fmul_rn(b_s[r], b_s[r]);
    for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(b_s[c * nps + r], b_s[c * nps + r]));
    bn_s[r] = n2;
  }
  __syncthreads();
  if (!__any_sync(kFull, s < S)) return;  // the warp's queries are past S

  for (int j0 = 0; j0 < N; j0 += RES_STEP) {
    float d[4 * R];
    int jj[4 * R];
    bool ok[4 * R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jb = j0 + 64 * r + 4 * tx;
      if (jb >= nps) {  // past the staged cloud: nothing to read
#pragma unroll
        for (int u = 0; u < 4; ++u) ok[4 * r + u] = false;
        continue;
      }
      float acc[4];
      {
        const float4 v = *reinterpret_cast<const float4*>(b_s + jb);
        acc[0] = __fmul_rn(qr[0], v.x);
        acc[1] = __fmul_rn(qr[0], v.y);
        acc[2] = __fmul_rn(qr[0], v.z);
        acc[3] = __fmul_rn(qr[0], v.w);
      }
#pragma unroll
      for (int c = 1; c < C_SMALL; ++c) {
        if (c < C) {
          const float4 v = *reinterpret_cast<const float4*>(b_s + c * nps + jb);
          acc[0] = __fadd_rn(acc[0], __fmul_rn(qr[c], v.x));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(qr[c], v.y));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(qr[c], v.z));
          acc[3] = __fadd_rn(acc[3], __fmul_rn(qr[c], v.w));
        }
      }
      const float4 bn = *reinterpret_cast<const float4*>(bn_s + jb);
      const float bnv[4] = {bn.x, bn.y, bn.z, bn.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ok[4 * r + u] = s < S && jb + u < N;
        d[4 * r + u] = distance<true>(qn, bnv[u], acc[u]);
        jj[4 * r + u] = jb + u;
      }
    }
    offer_step(sel, ql, s < S, j0 == 0, d, jj, ok, k, lane);
    sel.merge(ql, tx, 16);
  }
  if (s < S) sel.write(ql, out_d, out_i, static_cast<size_t>(b) * S + s, tx, 16);
}

template <int QPT, bool QRES>
__global__ void __launch_bounds__(THREADS, QPT == 4 ? 3 : 4) knn_kernel_stream(const Args a) {
  stream<QPT, QRES, false, 0>(a);
}

__global__ void knn_kernel_norms(const float* __restrict__ x, float* __restrict__ out, int rows,
                                 int C) {
  row_norms(x, out, rows, C);
}

template <int QPT, bool QRES>
cudaError_t launch_stream(const Args& a, float* norms, int B, cudaStream_t st) {
  knn_kernel_norms<<<mpa::ceil_div(B * a.N, 256), 256, 0, st>>>(a.base, norms, B * a.N, a.C);
  return launch(knn_kernel_stream<QPT, QRES>, mpa::ceil_div(a.S, 16 * QPT), B,
                stream_bytes(QPT, QRES, a.C, a.k, false), a, st);
}

}  // namespace

// base [B,N,C], query [B,S,C] f32 contiguous; out_d [B,S,k] f32, out_i [B,S,k]
// int32; norms [B,N] f32 scratch. Requires 1 <= k <= min(64, N) and
// 1 <= C <= 1024 (checked by the Python wrapper).
MPA_EXPORT int mpa_knn(const void* base, const void* query, void* norms, void* out_d,
                       void* out_i, int B, int N, int S, int C, int k, void* stream) {
  if (B == 0 || S == 0) return cudaGetLastError();
  Args a{};
  a.base = static_cast<const float*>(base);
  a.query = static_cast<const float*>(query);
  a.norms = static_cast<const float*>(norms);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.N = N;
  a.S = S;
  a.C = C;
  a.k = k;
  cudaStream_t st = mpa::as_stream(stream);
  const int nps = mpa::ceil_div(N, BT) * BT;
  const size_t res_bytes = sizeof(float) * static_cast<size_t>(C + 1) * nps;
  if (C <= C_SMALL && res_bytes <= RESIDENT_BYTES) {
    const size_t smem = res_bytes + Sel::bytes(16, k, RES_STEP);
    cudaError_t err = mpa::allow_smem(knn_kernel_resident, smem);
    if (err != cudaSuccess) return err;
    knn_kernel_resident<<<dim3(mpa::ceil_div(S, 16), B), THREADS, smem, st>>>(
        a.base, a.query, a.out_d, a.out_i, N, S, C, k, nps);
    return cudaGetLastError();
  }
  // 4 x 4 micro-tiles (64 queries a block, the query tile staged) where the
  // distances are long enough (16 <= C <= Q_RESIDENT) for the cross term to
  // dominate and there are blocks enough to fill the card; otherwise 1 x 4
  // (16 queries a block), the query tile staged up to Q_RESIDENT channels
  // and streamed with the base above.
  const bool wide = C >= 16 && C <= Q_RESIDENT &&
                    static_cast<long long>(mpa::ceil_div(S, 64)) * B >= 256;
  float* np = static_cast<float*>(norms);
  if (wide) return launch_stream<4, true>(a, np, B, st);
  return C <= Q_RESIDENT ? launch_stream<1, true>(a, np, B, st)
                         : launch_stream<1, false>(a, np, B, st);
}
