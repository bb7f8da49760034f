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
// What bounds it on the H100: the S*2bn*(2C+3) distance operations in f32 on
// the CUDA cores, at best half the FMA peak without FMA. At the model's
// shapes the feature searches (C = 64, 128) carry nearly all of them; the
// coordinate searches (C = 3) are a few microseconds of work each. In
// practice the selection and the latency of short blocks bound it: on an
// NVIDIA H100 80GB HBM3 at 700 W (profile_port.py --kernels, PERF.md
// section 6) markov_semseg's 22 launches take about 1.02 ms against 1.77
// for the design before this one, 0.35 of it the 14 coordinate searches,
// against a bound of 0.077.
//
// Design: knn_kernel's search forms (knn_search.cuh) over a window instead
// of the whole cloud, with the selection in registers (knn_topk.cuh
// list_insert, merge_lists). A block owns a tile of queries of one padded
// chunk, so all of them share one window. Resident form (C <= 8): the
// block stages the window once, channel-major with its norms; 1 to 32
// threads a query, as many as fill the card, each computing every such
// group of 4 rows, from the row the query's own position maps to
// (wrapping), so that the nearest rows come first. Streaming form: the
// window in 64-row tiles (from the block's position) and 32-channel
// chunks, a 4 x 4 or 1 x 4 register micro-tile of dot products, the rows'
// norms summed from the staged chunks; each tile's distances go to shared
// memory and 4 or 16 threads a query scan them. Each thread keeps a sorted
// list of the KMAX (8 or 32) smallest of its rows; a query's threads merge
// theirs with shuffles, then write the direct-form distances. knn_kernel's
// shared threshold is not used here: in a short Morton window most
// candidates beat it, and its bound, queue and merges took 78% of this
// kernel's time (PERF.md section 6). Front and back pad rows are never
// computed nor written. ops/window.py::windowed_knn_form fixes the form by
// the shape; this entry refuses any other. The TPU's one-hot window blocks
// and its hi/lo bf16 cross term are matrix-unit workarounds and are not
// carried over.
#include "knn_search.cuh"

namespace {

using namespace mpa::knn;

template <int KMAX>
__global__ void __launch_bounds__(THREADS) windowed_knn_kernel_resident(const Args a) {
  resident_window<KMAX>(a);
}

template <int QPT, bool QRES, int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX > 8 ? 2 : QPT == 4 ? 3 : 4)
windowed_knn_kernel_stream(const Args a) {
  stream<QPT, QRES, true, KMAX>(a);
}

template <int KMAX>
cudaError_t launch_resident(const Args& a, int B, cudaStream_t st) {
  return launch(windowed_knn_kernel_resident<KMAX>, (a.n_chunks + 1) * a.tiles, B,
                resident_window_bytes(a.C, a.nps, a.k), a, st);
}

template <int KMAX>
cudaError_t launch_stream(const Args& a, int qpt, int B, cudaStream_t st) {
  const int x = (a.n_chunks + 1) * a.tiles;
  if (qpt == 4)
    return launch(windowed_knn_kernel_stream<4, true, KMAX>, x, B,
                  stream_bytes(4, true, a.C, a.k, true), a, st);
  if (a.C <= Q_RESIDENT)
    return launch(windowed_knn_kernel_stream<1, true, KMAX>, x, B,
                  stream_bytes(1, true, a.C, a.k, true), a, st);
  return launch(windowed_knn_kernel_stream<1, false, KMAX>, x, B,
                stream_bytes(1, false, a.C, a.k, true), a, st);
}

}  // namespace

// base [B,N,C], query [B,S,C] f32 contiguous, 16-byte aligned; out_d
// [B,S,k] f32, out_i [B,S,k] int32; the window spec (sq, bn, n_chunks) as
// make_window_spec gives it: S == n_chunks * sq, N == n_chunks * bn,
// n_chunks >= 2. Requires 1 <= k <= min(32, 2*bn) and 1 <= C <= 1024
// (checked by the Python wrapper). The form (ops/window.py
// windowed_knn_form): resident (`resident_form` != 0; C <= 8 and the window
// within RESIDENT_BYTES) with `par` threads a query (1 to 32, a power of
// two), or streaming with `par` queries a thread (1, or 4 where C <= 128).
// Anything else returns cudaErrorInvalidValue.
MPA_EXPORT int mpa_windowed_knn(const void* base, const void* query, void* out_d, void* out_i,
                                int B, int N, int S, int C, int k, int sq, int bn, int n_chunks,
                                int resident_form, int par, void* stream) {
  if (B == 0 || S == 0) return cudaGetLastError();
  Args a{};
  a.base = static_cast<const float*>(base);
  a.query = static_cast<const float*>(query);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int*>(out_i);
  a.N = N;
  a.S = S;
  a.C = C;
  a.k = k;
  a.sq = sq;
  a.bn = bn;
  a.n_chunks = n_chunks;
  cudaStream_t st = mpa::as_stream(stream);
  if (resident_form) {
    a.nps = mpa::ceil_div(2 * bn, BT) * BT;
    if (C > C_SMALL || sizeof(float) * static_cast<size_t>(C + 1) * a.nps > RESIDENT_BYTES ||
        par < 1 || par > 32 || (par & (par - 1)) != 0)
      return cudaErrorInvalidValue;
    a.lanes = par;
    a.tiles = mpa::ceil_div(sq, THREADS / par);
    return k <= 8 ? launch_resident<8>(a, B, st) : launch_resident<32>(a, B, st);
  }
  if ((par != 1 && par != 4) || (par == 4 && C > Q_RESIDENT)) return cudaErrorInvalidValue;
  a.tiles = mpa::ceil_div(sq, 16 * par);
  return k <= 8 ? launch_stream<8>(a, par, B, st) : launch_stream<32>(a, par, B, st);
}
