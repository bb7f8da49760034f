// The two search forms shared by knn_kernel (knn.cu, over the whole cloud)
// and windowed_knn_kernel (window_knn.cu, over each query chunk's Morton
// window). A block owns a tile of queries that all search one range of base
// rows: the whole cloud, or the window of the padded chunk the tile lies in
// (a tile never straddles two chunks). Distances are the expanded form
// |q|^2 + |b|^2 - 2 q.b, each dot product summed in channel order with
// separately rounded multiplies and adds (no FMA), clamped at 0 for the
// exact search and not clamped for the windowed one, as their plain
// versions (ops/pairwise.py, ops/window.py) compute them.
//
// - resident (C <= 8): the block stages its range channel-major in shared
//   memory with its norms, once. The exact search (knn.cu,
//   knn_kernel_resident): each warp owns 2 queries (16 lanes a query, 16
//   base rows a lane) and walks the cloud RES_STEP rows a step with no
//   block barrier. The windowed search (resident_window): 1 to 32 threads
//   a query, each taking every such group of 4 rows, from the row the
//   query's own position maps to.
// - streaming: a block owns 16 * QPT queries, staged channel-major where
//   C <= Q_RESIDENT (streamed with the base above); the range streams
//   through shared memory in tiles of 64 rows and chunks of 32 channels,
//   fetched into registers one chunk ahead; each thread keeps a QPT x 4
//   micro-tile of dot products (QPT = 4: two float4 loads feed 16
//   multiplies and 16 adds per channel). The base norms come from a small
//   kernel ahead of it (row_norms; the windowed search sums them from the
//   staged chunks and takes its tiles from the block's position).
//
// Selection (knn_topk.cuh). The exact search: one sorted list of k per
// query in shared memory behind a shared threshold, group_bound on the
// first step, merges by rank; over a whole cloud the threshold soon turns
// nearly every candidate away. The windowed search: lists in registers. A
// window is short (256-4096 rows) and, in Morton order, brings a query's
// nearest rows late as often as early, so a shared threshold would queue
// most candidates; there each thread keeps a sorted list of the KMAX
// smallest of the rows it scans (the resident form: its groups of 4 rows;
// the streaming form: every (16 / QPT)-th row of each tile's distances,
// written to shared memory), and the threads of a query merge their lists
// with shuffles at the end. The exact search writes each list's expanded
// distances; the windowed one writes the direct-form distance
// sum_c (q_c - b_c)^2 to each selected row, in channel order
// (ops/window.py::direct_distance), and global indices.
#pragma once

#include "knn_topk.cuh"
#include "window.cuh"

namespace mpa {
namespace knn {

constexpr unsigned kFull = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int BT = 64;           // base rows per tile (16 lanes x 4)
constexpr int CH = 32;           // channels per staged chunk
constexpr int PF = BT * CH / THREADS;  // floats a thread fetches of each base chunk
constexpr int STR_B = BT + 4;    // row stride of a base chunk, float4-aligned
constexpr int Q_RESIDENT = 128;  // up to this many channels the query tile stays staged
constexpr int C_SMALL = 8;       // the resident form: C <= 8 ...
constexpr int RESIDENT_BYTES = 96 * 1024;  // ... and the range and its norms in 96 KB

// One launch. Windowed launches also carry the spec (ops/window.py
// WindowSpec) and `tiles`, the query tiles of a padded chunk.
struct Args {
  const float* base;   // [B, N, C]
  const float* query;  // [B, S, C]
  const float* norms;  // [B, N] |b|^2 (the exact search's streaming form)
  float* out_d;        // [B, S, k]
  int* out_i;          // [B, S, k]
  int N, S, C, k;
  int nps;    // resident: rows staged, the range rounded up to 64
  int lanes;  // windowed resident: threads a query (1-32, a power of two)
  int sq, bn, n_chunks, tiles;
};

// A block's queries [s0, s_end) and its base rows [j_lo, j_lo + nb).
struct Rows {
  int s0, s_end, j_lo, nb;
};

template <bool WIN>
__device__ __forceinline__ Rows block_rows(const Args& a, int qt) {
  if constexpr (WIN) {
    const int c = blockIdx.x / a.tiles;
    const WindowChunk w(c, a.S, a.sq, a.bn, a.n_chunks);
    const int s0 = w.s_lo + (blockIdx.x - c * a.tiles) * qt;
    return {s0, min(s0 + qt, w.s_hi), w.win0, 2 * a.bn};
  } else {
    const int s0 = blockIdx.x * qt;
    return {s0, min(s0 + qt, a.S), 0, a.N};
  }
}

// Distance of the expanded form from the dot product: the plain versions'
// operations and order; the exact search clamps at 0.
template <bool CLAMP>
__device__ __forceinline__ float distance(float qn, float bn, float cross) {
  const float d = __fsub_rn(__fadd_rn(qn, bn), __fmul_rn(2.f, cross));
  return CLAMP ? fmaxf(d, 0.f) : d;
}

// sum_c (q_c - b_c)^2 in channel order (ops/window.py::direct_distance):
// q's channels `qs` apart, b's contiguous; loads 32 channels ahead of the
// adds.
__device__ __forceinline__ float direct_distance(const float* q, int qs, const float* b, int C) {
  constexpr int U = 32;
  float d = 0.f;
  for (int c0 = 0; c0 < C; c0 += U) {
    float qv[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      qv[u] = c0 + u < C ? q[(c0 + u) * qs] : 0.f;
      bv[u] = c0 + u < C ? b[c0 + u] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < C) {
        const float diff = __fsub_rn(qv[u], bv[u]);
        d = c0 + u == 0 ? __fmul_rn(diff, diff) : __fadd_rn(d, __fmul_rn(diff, diff));
      }
    }
  }
  return d;
}

// -- the resident form ---------------------------------------------------------

// Shared memory of the windowed resident form: the window and its norms,
// and the neighbours' indices of up to THREADS queries.
inline size_t resident_window_bytes(int C, int nps, int k) {
  return sizeof(float) * static_cast<size_t>(C + 1) * nps +
         sizeof(int) * static_cast<size_t>(THREADS) * k;
}

// Window rows [0, nb) of bb [*, C] to b_s channel-major [C][nps] (rows
// nb..nps zero), their norms to bn_s [nps]; ends on a barrier. bb is
// 16-byte aligned and nb * C a multiple of 4, so a thread's float4 loads
// are issued eight at a time before any is stored.
__device__ __forceinline__ void stage_window(const float* __restrict__ bb, int nb, int C, int nps,
                                             float* b_s, float* bn_s) {
  constexpr int U = 8;
  const int t = threadIdx.x, n4 = nb * C / 4;
  const float4* src = reinterpret_cast<const float4*>(bb);
  for (int e0 = t; e0 < n4; e0 += U * THREADS) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e0 + u * THREADS < n4) v[u] = src[e0 + u * THREADS];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e < n4) {
        const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (4 * e + i) / C;
          b_s[(4 * e + i - r * C) * nps + r] = x[i];
        }
      }
    }
  }
  for (int r = nb + t; r < nps; r += THREADS) {
    for (int c = 0; c < C; ++c) b_s[c * nps + r] = 0.f;
  }
  __syncthreads();
  for (int r = t; r < nps; r += THREADS) {
    float n2 = __fmul_rn(b_s[r], b_s[r]);
    for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(b_s[c * nps + r], b_s[c * nps + r]));
    bn_s[r] = n2;
  }
  __syncthreads();
}

// The window row that query s's own position maps to (s N / S, both clouds
// Morton-ordered), as an offset into its window of nb rows: where the
// windowed search starts, so that the nearest rows come first and the
// lists' last entries turn most later rows away with one compare.
__device__ __forceinline__ int window_start(int s, int S, int N, int j_lo, int nb) {
  const int r = static_cast<int>(static_cast<long long>(s) * N / S) - j_lo;
  return min(max(r, 0), nb - 1);
}

// A query's coordinates (C <= C_SMALL) into registers and its |q|^2.
__device__ __forceinline__ float load_query(const float* q, int C, float (&qr)[C_SMALL]) {
  float qn = 0.f;
#pragma unroll
  for (int c = 0; c < C_SMALL; ++c) {
    qr[c] = 0.f;
    if (c < C) {
      qr[c] = q[c];
      qn = c == 0 ? __fmul_rn(qr[c], qr[c]) : __fadd_rn(qn, __fmul_rn(qr[c], qr[c]));
    }
  }
  return qn;
}

// The dot products of qr with the 4 staged rows jb..jb+3 (channel order).
__device__ __forceinline__ void cross4(const float* b_s, int nps, int jb, int C,
                                       const float (&qr)[C_SMALL], float (&acc)[4]) {
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
}

// The windowed search (k <= KMAX): a block serves THREADS / P queries,
// `lanes` (P) threads a query, each computing the distances of every P-th
// group of 4 window rows and keeping the KMAX smallest in registers. The P
// lists are merged by shuffles, the selected indices pass through shared
// memory ([THREADS / P] queries x k), and each of the P threads writes
// every P-th neighbour with its direct-form distance from the staged
// window.
template <int KMAX>
__device__ __forceinline__ void resident_window(const Args& a) {
  extern __shared__ float4 smem4[];
  const int C = a.C, k = a.k, nps = a.nps, P = a.lanes;
  const int QR = THREADS / P;
  float* b_s = reinterpret_cast<float*>(smem4);  // [C][nps] channel-major window
  float* bn_s = b_s + C * nps;                    // [nps] |b|^2
  int* sel_s = reinterpret_cast<int*>(bn_s + nps);  // [QR][k] the neighbours
  const int t = threadIdx.x, b = blockIdx.y;
  const int ql = t / P, p = t - ql * P;
  const Rows rows = block_rows<true>(a, QR);
  if (rows.s0 >= rows.s_end) return;  // an empty tile of an edge chunk
  const int nb = rows.nb, ng = nb / 4;  // nb = 2 bn, a multiple of 16
  const int s = rows.s0 + ql;
  const bool live = s < rows.s_end;
  const size_t row = static_cast<size_t>(b) * a.S + (live ? s : 0);
  float qr[C_SMALL];
  const float qn = load_query(a.query + row * C, C, qr);
  stage_window(a.base + (static_cast<size_t>(b) * a.N + rows.j_lo) * C, nb, C, nps, b_s, bn_s);
  if (!__any_sync(kFull, live)) return;  // the warp's queries are past the tile

  float ld[KMAX];
  int li[KMAX];
  list_init(ld, li);
  if (live) {
    // Groups of 4 rows from the query's own, wrapping: thread p takes every
    // P-th.
    const int g0 = window_start(s, a.S, a.N, rows.j_lo, nb) / 4;
    for (int i = p; i < ng; i += P) {
      const int jb = 4 * (i + g0 < ng ? i + g0 : i + g0 - ng);
      float acc[4];
      cross4(b_s, nps, jb, C, qr, acc);
      const float4 bn = *reinterpret_cast<const float4*>(bn_s + jb);
      const float bnv[4] = {bn.x, bn.y, bn.z, bn.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        list_insert(ld, li, distance<false>(qn, bnv[u], acc[u]), rows.j_lo + jb + u);
    }
  }
  int* mine = sel_s + ql * k;
  merge_lists(ld, li, k, p, P, mine);
  __syncwarp();
  if (!live) return;
  for (int r = p; r < k; r += P) {
    const int id = mine[r], local = id - rows.j_lo;
    float dd = NAN;  // where a NaN input left a sentinel
    if (local >= 0 && local < nb) {
#pragma unroll
      for (int c = 0; c < C_SMALL; ++c) {
        if (c < C) {
          const float diff = __fsub_rn(qr[c], b_s[c * nps + local]);
          dd = c == 0 ? __fmul_rn(diff, diff) : __fadd_rn(dd, __fmul_rn(diff, diff));
        }
      }
    }
    a.out_d[row * k + r] = dd;
    a.out_i[row * k + r] = id;
  }
}

// -- the streaming form ----------------------------------------------------------

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

// The windowed search's tile of distances: [16 * QPT][STR_D], rows padded
// so that the scan's reads (P = 16 / QPT threads a query, each every P-th
// row) fall in distinct banks.
template <int QPT>
__host__ __device__ constexpr int str_d() {
  return QPT == 4 ? BT + 4 : BT + 16;
}

// Shared memory of the streaming form.
inline size_t stream_bytes(int qpt, bool q_res, int C, int k, bool win) {
  const int QT = 16 * qpt;
  const int cq = q_res ? C : CH;
  // The windowed search: the tile's row norms and its distances.
  const size_t sel = win ? sizeof(float) * (BT + static_cast<size_t>(QT) *
                                                     (qpt == 4 ? str_d<4>() : str_d<1>()))
                         : Sel::bytes(QT, k, BT);
  return sizeof(float) * (static_cast<size_t>(cq) * (QT + 4) + CH * STR_B + QT) + sel;
}

// A block owns 16 * QPT queries and streams its range in tiles of 64 rows,
// each in chunks of 32 channels; each thread keeps a QPT x 4 micro-tile of
// dot products. QRES: the query tile stays staged (C <= Q_RESIDENT). WIN:
// the windowed search, lists of KMAX in registers (k <= KMAX), its row
// norms summed from the staged chunks (no pass ahead) and its query norms
// from the staged tile.
template <int QPT, bool QRES, bool WIN, int KMAX>
__device__ __forceinline__ void stream(const Args& a) {
  constexpr int QT = 16 * QPT;  // queries per block
  constexpr int QPW = 2 * QPT;  // queries per warp
  constexpr int G = 32 / QPW;   // lanes per query in a merge
  constexpr int STR_Q = QT + 4;
  constexpr int STR_D = str_d<QPT>();
  constexpr int PFQ = 4 * ((QT * CH / 4 + THREADS - 1) / THREADS);  // whole float4s
  const int C = a.C, k = a.k;
  const int cq = QRES ? C : CH;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [cq][STR_Q] the query tile
  float* b_s = q_s + cq * STR_Q;                  // [CH][STR_B] a chunk of the base tile
  float* qn_s = b_s + CH * STR_B;                 // [QT] |q|^2
  float* bnt_s = qn_s + QT;                       // WIN: [BT] the tile's row norms
  float* d_s = bnt_s + BT;                        // WIN: [QT][STR_D] a tile's distances
  const Sel sel(reinterpret_cast<char*>(qn_s + QT), QT, k, BT);  // exact search only

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int tx = t & 15, ty = t >> 4;  // base group of 4, query group of QPT
  const int mq = QPW * w + lane / G, sub = lane % G;  // the query this lane merges
  const int b = blockIdx.y;
  const Rows rows = block_rows<WIN>(a, QT);
  if (rows.s0 >= rows.s_end) return;  // an empty tile of an edge chunk
  const int s0 = rows.s0, s_end = rows.s_end, nb = rows.nb;
  const float* qb = a.query + static_cast<size_t>(b) * a.S * C;
  const float* bb = a.base + (static_cast<size_t>(b) * a.N + rows.j_lo) * C;

  if constexpr (!WIN) sel.init(mq, sub, G);
  float ld[WIN ? KMAX : 1];
  int li[WIN ? KMAX : 1];
  if constexpr (WIN) list_init(ld, li);
  if (!(WIN && QRES) && t < QT) {
    float n2 = 0.f;
    if (s0 + t < s_end) {
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
      fetch(v, qb, s0, QT, s_end, C, c0, cc);
      put(v, q_s + c0 * STR_Q, STR_Q, QT, C, cc);
    }
  }
  if constexpr (WIN && QRES) {  // |q|^2 from the staged tile (rows past s_end hold 0)
    __syncthreads();
    if (t < QT) {
      float n2 = __fmul_rn(q_s[t], q_s[t]);
      for (int c = 1; c < C; ++c) {
        const float v = q_s[c * STR_Q + t];
        n2 = __fadd_rn(n2, __fmul_rn(v, v));
      }
      qn_s[t] = n2;
    }
  }
  float nrm = 0.f;  // WIN, t < BT: row t's |b|^2 so far in the current tile

  // (tile, chunk) steps in order; each chunk is fetched into registers one
  // step ahead, so its loads overlap the step before. The windowed search
  // starts at the tile its middle query's position maps to, wrapping.
  const int n_cc = (C + CH - 1) / CH, n_tiles = (nb + BT - 1) / BT;
  const int steps = n_tiles * n_cc;
  const int t0 = WIN ? window_start(s0 + (s_end - s0) / 2, a.S, a.N, rows.j_lo, nb) / BT : 0;
  const auto tile_at = [&](int i) {
    return WIN ? (i + t0 < n_tiles ? i + t0 : i + t0 - n_tiles) : i;
  };
  float pb[PF], pq[PFQ];
  fetch(pb, bb, tile_at(0) * BT, BT, nb, C, 0, min(CH, C));
  if constexpr (!QRES) fetch(pq, qb, s0, QT, s_end, C, 0, CH);
  float acc[QPT][4];
  const float* bnb = a.norms + static_cast<size_t>(b) * a.N;  // the exact search's
  for (int step = 0; step < steps; ++step) {
    const int tile = step / n_cc, chunk = step - tile * n_cc;
    const int j0 = tile_at(tile) * BT, c0 = chunk * CH, cc = min(CH, C - c0);
    __syncthreads();  // the previous chunk (and tile of distances) has been consumed
    put(pb, b_s, STR_B, BT, C, cc);
    if constexpr (!QRES) put(pq, q_s, STR_Q, QT, C, cc);
    __syncthreads();
    if (step + 1 < steps) {
      const int nt = (step + 1) / n_cc, nc = (step + 1) - nt * n_cc;
      const int ncc = min(CH, C - nc * CH);
      fetch(pb, bb, tile_at(nt) * BT, BT, nb, C, nc * CH, ncc);
      if constexpr (!QRES) fetch(pq, qb, s0, QT, s_end, C, nc * CH, ncc);
    }
    if constexpr (WIN) {
      if (t < BT) {  // the chunk's channels of row t, in channel order
        for (int c = 0; c < cc; ++c) {
          const float v = b_s[c * STR_B + t];
          nrm = c0 + c == 0 ? __fmul_rn(v, v) : __fadd_rn(nrm, __fmul_rn(v, v));
        }
        if (chunk + 1 == n_cc) bnt_s[t] = nrm;
      }
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
    if (chunk + 1 < n_cc) continue;

    if constexpr (WIN) {
      // The tile's distances to shared memory; thread (q, p) of the P that
      // share query q scans rows p, p + P, ... into its list.
      constexpr int P = 16 / QPT;
      __syncthreads();  // the tile's row norms
      float bnv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bnv[j] = bnt_s[tx * 4 + j];
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        float4 dv;
        dv.x = distance<false>(qn_s[ty * QPT + i], bnv[0], acc[i][0]);
        dv.y = distance<false>(qn_s[ty * QPT + i], bnv[1], acc[i][1]);
        dv.z = distance<false>(qn_s[ty * QPT + i], bnv[2], acc[i][2]);
        dv.w = distance<false>(qn_s[ty * QPT + i], bnv[3], acc[i][3]);
        *reinterpret_cast<float4*>(d_s + (ty * QPT + i) * STR_D + tx * 4) = dv;
      }
      __syncthreads();
      const int q = t / P, p = t - q * P;
      if (s0 + q < s_end) {
#pragma unroll
        for (int m = 0; m < BT / P; ++m) {
          const int r = p + P * m;
          if (j0 + r < nb) list_insert(ld, li, d_s[q * STR_D + r], rows.j_lo + j0 + r);
        }
      }
    } else {
      float bnv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bnv[j] = j0 + tx * 4 + j < nb ? bnb[j0 + tx * 4 + j] : 0.f;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int ql = ty * QPT + i;
        float d[4];
        int jj[4];
        bool ok[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ok[u] = s0 + ql < s_end && j0 + tx * 4 + u < nb;
          d[u] = distance<true>(qn_s[ql], bnv[u], acc[i][u]);
          jj[u] = j0 + tx * 4 + u;
        }
        offer_step(sel, ql, s0 + ql < s_end, j0 == 0, d, jj, ok, k, lane);
      }
      sel.merge(mq, sub, G);
    }
  }
  if constexpr (WIN) {
    // The P lists of each query merged, the indices through shared memory
    // (the distance tile's), then each of the P threads writes every P-th
    // neighbour with its direct-form distance (the query from the staged
    // tile or device memory, the row from device memory).
    constexpr int P = 16 / QPT;
    const int q = t / P, p = t - q * P;
    int* mine = reinterpret_cast<int*>(d_s) + q * k;
    __syncthreads();  // the last tile's distances have been scanned
    merge_lists(ld, li, k, p, P, mine);
    __syncwarp();
    if (s0 + q < s_end) {
      const size_t row = static_cast<size_t>(b) * a.S + s0 + q;
      const float* qr = QRES ? q_s + q : qb + static_cast<size_t>(s0 + q) * C;
      for (int r = p; r < k; r += P) {
        const int id = mine[r];
        float dd = NAN;  // where a NaN input left a sentinel
        if (id >= rows.j_lo && id < rows.j_lo + nb)
          dd = direct_distance(qr, QRES ? STR_Q : 1,
                               a.base + (static_cast<size_t>(b) * a.N + id) * C, C);
        a.out_d[row * k + r] = dd;
        a.out_i[row * k + r] = id;
      }
    }
  } else {
    if (s0 + mq < s_end) sel.write(mq, a.out_d, a.out_i, static_cast<size_t>(b) * a.S + s0 + mq,
                                   sub, G);
  }
}

// |x|^2 of each of the `rows` rows of x [rows, C], in the plain version's
// channel order, one thread a row.
__device__ __forceinline__ void row_norms(const float* __restrict__ x, float* __restrict__ out,
                                          int rows, int C) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + static_cast<size_t>(r) * C;
  float n2 = __fmul_rn(xr[0], xr[0]);
  for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(xr[c], xr[c]));
  out[r] = n2;
}

// Launch `kernel` on a grid of (x, B) blocks of THREADS with `smem` bytes.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int x, int B, size_t smem, const Args& a, cudaStream_t st) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(x, B), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace knn
}  // namespace mpa
