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
// Design. The selection (knn_topk.cuh) keeps one sorted list of k per query
// in shared memory, its k-th pair the query's threshold: a distance is
// queued only if it comes before that pair in (dist, idx) order, and a group
// of lanes merges the queue into the list by rank after each step of base
// points, so nearly every candidate costs one compare once the list has
// filled. On the first step, whose list is empty, a candidate is queued only
// if it is no later than the k-th smallest of the 16 lane minima, a bound on
// the step's k-th best. Two forms compute the distances:
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
#include "knn_topk.cuh"

namespace {

using mpa::key_less;

constexpr unsigned kFull = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int BT = 64;           // base points per tile (16 lanes x 4)
constexpr int CH = 32;           // channels per staged chunk
constexpr int STR_B = BT + 4;    // row stride of a base chunk, float4-aligned
constexpr int Q_RESIDENT = 128;  // up to this many channels the query tile stays staged
constexpr int PF = BT * CH / THREADS;  // floats a thread fetches of each base chunk
constexpr int C_SMALL = 8;       // the resident form: C <= 8 ...
constexpr int RESIDENT_BYTES = 96 * 1024;  // ... and the cloud and its norms in 96 KB

// The selection state of QT queries in shared memory (knn_topk.cuh): each
// query's threshold (its list's k-th pair), queue length and current list
// buffer, its queue of up to `cap` candidates (one step's), and two list
// buffers of k.
struct Sel {
  float* thr_d;
  int* thr_i;
  int* cnt;
  int* cur;
  float* cand_d;
  int* cand_i;
  float* list_d;
  int* list_i;
  int k, qt, cap;

  static size_t bytes(int qt, int k, int cap) {
    return (sizeof(float) + sizeof(int)) * (static_cast<size_t>(qt) * cap + 2 * qt * k + qt) +
           2 * sizeof(int) * qt;
  }
  // Carve the state out of `p` (4-byte aligned); queues of `cap`.
  __device__ Sel(char* p, int qt_, int k_, int cap_) : k(k_), qt(qt_), cap(cap_) {
    thr_d = reinterpret_cast<float*>(p);
    cand_d = thr_d + qt;
    list_d = cand_d + qt * cap;
    thr_i = reinterpret_cast<int*>(list_d + 2 * qt * k);
    cnt = thr_i + qt;
    cur = cnt + qt;
    cand_i = cur + qt;
    list_i = cand_i + qt * cap;
  }
  __device__ float* ld(int q, int buf) const { return list_d + (buf * qt + q) * k; }
  __device__ int* li(int q, int buf) const { return list_i + (buf * qt + q) * k; }

  // Query q's empty list; the g lanes of its group from `sub`.
  __device__ void init(int q, int sub, int g) const {
    mpa::topk_init(ld(q, 0), li(q, 0), k, sub, g);
    if (sub == 0) {
      thr_d[q] = INFINITY;
      thr_i[q] = INT_MAX;
      cnt[q] = 0;
      cur[q] = 0;
    }
  }
  // Queue (d, j) for query q if it beats the threshold (td, ti).
  __device__ void offer(int q, float d, int j, float td, int ti) const {
    if (key_less(d, j, td, ti)) {
      const int pos = atomicAdd(cnt + q, 1);
      cand_d[q * cap + pos] = d;
      cand_i[q * cap + pos] = j;
    }
  }
  // Every lane of the warp, after its offers: each group merges the queue of
  // its query q into the other list buffer and moves the threshold there.
  __device__ void merge(int q, int sub, int g) const {
    __syncwarp();
    const int m = cnt[q];
    if (!__any_sync(kFull, m > 0)) return;
    const int b = cur[q];
    if (m > 0)
      mpa::topk_merge(ld(q, b), li(q, b), ld(q, 1 - b), li(q, 1 - b), k, cand_d + q * cap,
                      cand_i + q * cap, m, sub, g);
    __syncwarp();
    if (m > 0 && sub == 0) {
      thr_d[q] = ld(q, 1 - b)[k - 1];
      thr_i[q] = li(q, 1 - b)[k - 1];
      cur[q] = 1 - b;
      cnt[q] = 0;
    }
    __syncwarp();
  }
  // Query q's list to out (row s of k), by the g lanes of its group.
  __device__ void write(int q, float* out_d, int* out_i, size_t row, int sub, int g) const {
    const int b = cur[q];
    for (int i = sub; i < k; i += g) {
      out_d[row * k + i] = ld(q, b)[i];
      out_i[row * k + i] = li(q, b)[i];
    }
  }
};

// Distance of the expanded form from the dot product: the plain version's
// operations and order (ops/pairwise.py).
__device__ __forceinline__ float distance(float qn, float bn, float cross) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, bn), __fmul_rn(2.f, cross)), 0.f);
}

// Offer a lane's NC distances d (to base points j; `ok` marks the real
// ones) to query q (`live`: q is a query of this launch). On the first
// step, where the list is still empty, only those no later than the
// group's bound (group_bound) are offered: the k best of the step, and few
// more. Every lane calls it.
template <int NC>
__device__ __forceinline__ void offer_step(const Sel& sel, int q, bool live, bool first,
                                           float (&d)[NC], int (&j)[NC], const bool (&ok)[NC],
                                           int k, int lane) {
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    if (!ok[u]) {
      d[u] = INFINITY;
      j[u] = INT_MAX - 16 + (lane & 15);  // distinct across the group
    }
  }
  float bd = INFINITY;
  int bi = INT_MAX;
  if (first) mpa::group_bound(d, j, k, lane, bd, bi);
  if (!live) return;
  const float td = sel.thr_d[q];
  const int ti = sel.thr_i[q];
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    if (ok[u] && !key_less(bd, bi, d[u], j[u])) sel.offer(q, d[u], j[u], td, ti);
  }
}

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
        d[4 * r + u] = distance(qn, bnv[u], acc[u]);
        jj[4 * r + u] = jb + u;
      }
    }
    offer_step(sel, ql, s < S, j0 == 0, d, jj, ok, k, lane);
    sel.merge(ql, tx, 16);
  }
  if (s < S) sel.write(ql, out_d, out_i, static_cast<size_t>(b) * S + s, tx, 16);
}

// -- the streaming form: the cloud through shared memory in chunks ----------

// The floats a thread fetches of rows [r0, r0 + rows) of src [*, C],
// channels [c0, c0 + cc), rows at or past `limit` reading 0: as float4s
// where C is a multiple of 4 (then so is cc), else one by one; PER is a
// multiple of 4. All loads are issued before any is used, so one memory
// latency covers the chunk.
template <int PER>
__device__ __forceinline__ void fetch(float (&v)[PER], const float* src, int r0, int rows,
                                      int limit, int C, int c0, int cc) {
  if (C % 4 == 0) {
    const int cc4 = cc >> 2;
#pragma unroll
    for (int u = 0; u < PER / 4; ++u) {
      const int e = threadIdx.x + u * THREADS;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < rows * cc4) {
        const int r = e / cc4, c = 4 * (e - r * cc4);
        if (r0 + r < limit)
          x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * C + c0 + c);
      }
      v[4 * u] = x.x;
      v[4 * u + 1] = x.y;
      v[4 * u + 2] = x.z;
      v[4 * u + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = threadIdx.x + u * THREADS;
      v[u] = 0.f;
      if (e < rows * cc) {
        const int r = e / cc, c = e - r * cc;
        if (r0 + r < limit) v[u] = src[static_cast<size_t>(r0 + r) * C + c0 + c];
      }
    }
  }
}

// The fetched floats into dst, channel-major [cc][stride].
template <int PER>
__device__ __forceinline__ void put(const float (&v)[PER], float* dst, int stride, int rows,
                                    int C, int cc) {
  if (C % 4 == 0) {
    const int cc4 = cc >> 2;
#pragma unroll
    for (int u = 0; u < PER / 4; ++u) {
      const int e = threadIdx.x + u * THREADS;
      if (e < rows * cc4) {
        const int r = e / cc4, c = 4 * (e - r * cc4);
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[(c + i) * stride + r] = v[4 * u + i];
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = threadIdx.x + u * THREADS;
      if (e < rows * cc) {
        const int r = e / cc, c = e - r * cc;
        dst[c * stride + r] = v[u];
      }
    }
  }
}

// Shared memory of the streaming form.
size_t stream_bytes(int qpt, bool q_res, int C, int k) {
  const int QT = 16 * qpt;
  const int cq = q_res ? C : CH;
  return sizeof(float) * (static_cast<size_t>(cq) * (QT + 4) + CH * STR_B + QT) +
         Sel::bytes(QT, k, BT);
}

// A block owns 16 * QPT queries and streams the base in tiles of 64 points,
// each in chunks of 32 channels; each thread keeps a QPT x 4 micro-tile of
// dot products. QRES: the query tile stays staged (C <= Q_RESIDENT).
template <int QPT, bool QRES>
__global__ void __launch_bounds__(THREADS, QPT == 4 ? 3 : 4)
knn_kernel_stream(const float* __restrict__ base, const float* __restrict__ query,
                  const float* __restrict__ norms, float* __restrict__ out_d,
                  int* __restrict__ out_i, int N, int S, int C, int k) {
  constexpr int QT = 16 * QPT;  // queries per block
  constexpr int QPW = 2 * QPT;  // queries per warp
  constexpr int G = 32 / QPW;   // lanes per query in a merge
  constexpr int STR_Q = QT + 4;
  constexpr int PFQ = 4 * ((QT * CH / 4 + THREADS - 1) / THREADS);  // whole float4s
  const int cq = QRES ? C : CH;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [cq][STR_Q] the query tile
  float* b_s = q_s + cq * STR_Q;                  // [CH][STR_B] a chunk of the base tile
  float* qn_s = b_s + CH * STR_B;                 // [QT] |q|^2
  const Sel sel(reinterpret_cast<char*>(qn_s + QT), QT, k, BT);

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int tx = t & 15, ty = t >> 4;  // base group of 4, query group of QPT
  const int mq = QPW * w + lane / G, sub = lane % G;  // the query this lane merges
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * QT;
  const float* qb = query + static_cast<size_t>(b) * S * C;
  const float* bb = base + static_cast<size_t>(b) * N * C;

  sel.init(mq, sub, G);
  if (t < QT) {
    float n2 = 0.f;
    if (s0 + t < S) {
      const float* qr = qb + static_cast<size_t>(s0 + t) * C;
      n2 = __fmul_rn(qr[0], qr[0]);
      for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(qr[c], qr[c]));
    }
    qn_s[t] = n2;
  }
  if constexpr (QRES) {
    for (int c0 = 0; c0 < C; c0 += CH) {
      float v[PFQ];
      const int cc = min(CH, C - c0);
      fetch(v, qb, s0, QT, S, C, c0, cc);
      put(v, q_s + c0 * STR_Q, STR_Q, QT, C, cc);
    }
  }

  // (tile, chunk) steps in order; each chunk is fetched into registers one
  // step ahead, so its loads overlap the step before.
  const int n_chunks = (C + CH - 1) / CH;
  const int steps = ((N + BT - 1) / BT) * n_chunks;
  float pb[PF], pq[PFQ];
  fetch(pb, bb, 0, BT, N, C, 0, min(CH, C));
  if constexpr (!QRES) fetch(pq, qb, s0, QT, S, C, 0, CH);
  float acc[QPT][4];
  const float* bnb = norms + static_cast<size_t>(b) * N;
  for (int step = 0; step < steps; ++step) {
    const int tile = step / n_chunks, chunk = step - tile * n_chunks;
    const int j0 = tile * BT, c0 = chunk * CH, cc = min(CH, C - c0);
    __syncthreads();  // the previous chunk has been consumed
    put(pb, b_s, STR_B, BT, C, cc);
    if constexpr (!QRES) put(pq, q_s, STR_Q, QT, C, cc);
    __syncthreads();
    if (step + 1 < steps) {
      const int nt = (step + 1) / n_chunks, nc = (step + 1) - nt * n_chunks;
      const int ncc = min(CH, C - nc * CH);
      fetch(pb, bb, nt * BT, BT, N, C, nc * CH, ncc);
      if constexpr (!QRES) fetch(pq, qb, s0, QT, S, C, nc * CH, ncc);
    }
    const float* qc = QRES ? q_s + c0 * STR_Q : q_s;
    int c = 0;
    if (c0 == 0) {
      const float4 bv = *reinterpret_cast<const float4*>(b_s + tx * 4);
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float qa = qc[ty * QPT + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmul_rn(qa, ba[j]);
      }
      c = 1;
    }
#pragma unroll 4
    for (; c < cc; ++c) {
      float qa[QPT];
      if constexpr (QPT == 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qc + c * STR_Q + ty * QPT);
        qa[0] = qv.x;
        qa[1] = qv.y;
        qa[2] = qv.z;
        qa[3] = qv.w;
      } else {
#pragma unroll
        for (int i = 0; i < QPT; ++i) qa[i] = qc[c * STR_Q + ty * QPT + i];
      }
      const float4 bv = *reinterpret_cast<const float4*>(b_s + c * STR_B + tx * 4);
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(qa[i], ba[j]));
      }
    }
    if (chunk + 1 < n_chunks) continue;

    float bnv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bnv[j] = j0 + tx * 4 + j < N ? bnb[j0 + tx * 4 + j] : 0.f;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int ql = ty * QPT + i;
      float d[4];
      int jj[4];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ok[u] = s0 + ql < S && j0 + tx * 4 + u < N;
        d[u] = distance(qn_s[ql], bnv[u], acc[i][u]);
        jj[u] = j0 + tx * 4 + u;
      }
      offer_step(sel, ql, s0 + ql < S, j0 == 0, d, jj, ok, k, lane);
    }
    sel.merge(mq, sub, G);
  }
  if (s0 + mq < S) sel.write(mq, out_d, out_i, static_cast<size_t>(b) * S + s0 + mq, sub, G);
}

// |x|^2 of each of the `rows` rows of x [rows, C], in the plain version's
// channel order, one thread a row.
__global__ void knn_kernel_norms(const float* __restrict__ x, float* __restrict__ out, int rows,
                                 int C) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + static_cast<size_t>(r) * C;
  float n2 = __fmul_rn(xr[0], xr[0]);
  for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(xr[c], xr[c]));
  out[r] = n2;
}

template <int QPT, bool QRES>
cudaError_t launch_stream(const float* base, const float* query, float* norms, float* out_d,
                          int* out_i, int B, int N, int S, int C, int k, cudaStream_t st) {
  const size_t smem = stream_bytes(QPT, QRES, C, k);
  cudaError_t err = mpa::allow_smem(knn_kernel_stream<QPT, QRES>, smem);
  if (err != cudaSuccess) return err;
  knn_kernel_norms<<<mpa::ceil_div(B * N, 256), 256, 0, st>>>(base, norms, B * N, C);
  knn_kernel_stream<QPT, QRES><<<dim3(mpa::ceil_div(S, 16 * QPT), B), THREADS, smem, st>>>(
      base, query, norms, out_d, out_i, N, S, C, k);
  return cudaGetLastError();
}

}  // namespace

// base [B,N,C], query [B,S,C] f32 contiguous; out_d [B,S,k] f32, out_i [B,S,k]
// int32; norms [B,N] f32 scratch. Requires 1 <= k <= min(64, N) and
// 1 <= C <= 1024 (checked by the Python wrapper).
MPA_EXPORT int mpa_knn(const void* base, const void* query, void* norms, void* out_d,
                       void* out_i, int B, int N, int S, int C, int k, void* stream) {
  if (B == 0 || S == 0) return cudaGetLastError();
  auto bp = static_cast<const float*>(base);
  auto qp = static_cast<const float*>(query);
  auto np = static_cast<float*>(norms);
  auto dp = static_cast<float*>(out_d);
  auto ip = static_cast<int*>(out_i);
  cudaStream_t st = mpa::as_stream(stream);
  const int nps = mpa::ceil_div(N, BT) * BT;
  const size_t res_bytes = sizeof(float) * static_cast<size_t>(C + 1) * nps;
  if (C <= C_SMALL && res_bytes <= RESIDENT_BYTES) {
    const size_t smem = res_bytes + Sel::bytes(16, k, RES_STEP);
    cudaError_t err = mpa::allow_smem(knn_kernel_resident, smem);
    if (err != cudaSuccess) return err;
    knn_kernel_resident<<<dim3(mpa::ceil_div(S, 16), B), THREADS, smem, st>>>(bp, qp, dp, ip, N, S, C,
                                                                       k, nps);
    return cudaGetLastError();
  }
  // 4 x 4 micro-tiles (64 queries a block, the query tile staged) where the
  // distances are long enough (16 <= C <= Q_RESIDENT) for the cross term to
  // dominate and there are blocks enough to fill the card; otherwise 1 x 4
  // (16 queries a block), the query tile staged up to Q_RESIDENT channels
  // and streamed with the base above.
  const bool wide = C >= 16 && C <= Q_RESIDENT &&
                    static_cast<long long>(mpa::ceil_div(S, 64)) * B >= 256;
  if (wide) return launch_stream<4, true>(bp, qp, np, dp, ip, B, N, S, C, k, st);
  return C <= Q_RESIDENT ? launch_stream<1, true>(bp, qp, np, dp, ip, B, N, S, C, k, st)
                         : launch_stream<1, false>(bp, qp, np, dp, ip, B, N, S, C, k, st);
}
