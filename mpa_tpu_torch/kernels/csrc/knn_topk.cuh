// Top-k selection, two ways (used through the search forms of
// knn_search.cuh):
// - against a threshold shared per query, in shared memory (Sel,
//   offer_step; knn_kernel, whose searches run over whole clouds);
// - in registers (list_insert, merge_lists; windowed_knn_kernel, whose
//   windows are short): each thread keeps a sorted list of the KMAX
//   smallest of the rows it scans, and the P threads that share a query
//   merge their lists with shuffles at the end.
//
// Sel: each query owns one sorted list of k
// (dist, idx) pairs and a queue of candidates. A candidate is queued only if
// it comes before the list's k-th pair in the lexicographic (dist, idx)
// order, the order of lax.top_k and of a stable sort; once the list has
// settled nearly every candidate costs that one compare. A group of lanes
// merges a query's queue into its list by rank, writing the merged list into
// the query's other buffer: every pair's new place is the number of pairs
// before it, so the k pairs kept and their order do not depend on the order
// in which the candidates were queued (ties go to the lowest index whatever
// the arrival order). Indices in a list and its queue are distinct; the
// empty list holds k sentinels (INF, INT_MAX - k + 1 + i), after every real
// pair.
#pragma once

#include "common.cuh"

namespace mpa {

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// The k sentinels of an empty list, written by the `g` lanes from `sub`.
__device__ __forceinline__ void topk_init(float* ld, int* li, int k, int sub, int g) {
  for (int i = sub; i < k; i += g) {
    ld[i] = INFINITY;
    li[i] = INT_MAX - k + 1 + i;
  }
}

// A bound for a 16-lane group holding NC candidates a lane: the k-th
// smallest of the 16 lane minima, which is no smaller than the group's k-th
// smallest candidate (the k smallest minima are k distinct candidates), so a
// candidate after it can never be among the group's k best. Keys must be
// distinct across lanes; (INF, INT_MAX) where k > 16. Every lane of the warp
// calls it, each half for its own group.
template <int NC>
__device__ __forceinline__ void group_bound(const float (&d)[NC], const int (&j)[NC], int k,
                                            int lane, float& bd, int& bi) {
  float md = d[0];
  int mi = j[0];
#pragma unroll
  for (int r = 1; r < NC; ++r) {
    if (key_less(d[r], j[r], md, mi)) {
      md = d[r];
      mi = j[r];
    }
  }
  int rank = 0;
#pragma unroll
  for (int l = 0; l < 16; ++l) {
    const float od = __shfl_sync(0xffffffffu, md, l, 16);
    const int oi = __shfl_sync(0xffffffffu, mi, l, 16);
    rank += key_less(od, oi, md, mi);
  }
  const unsigned mine = (__ballot_sync(0xffffffffu, rank == k - 1) >> (lane & 16)) & 0xffffu;
  const int src = mine ? __ffs(mine) - 1 : 0;
  const float sd = __shfl_sync(0xffffffffu, md, src, 16);
  const int si = __shfl_sync(0xffffffffu, mi, src, 16);
  bd = INFINITY;
  bi = INT_MAX;
  if (k <= 16 && mine) {
    bd = sd;
    bi = si;
  }
}

// Merge the m queued pairs (cd, ci) into the sorted list (ld, li) of k
// pairs, writing the k first of them, sorted, to (nd, ni); the `g` lanes of
// a group from `sub` share the pairs. A list pair at place i goes to i plus
// the queued pairs before it; a queued pair to the list pairs before it (a
// binary search) plus the queued pairs before it; places of k or more drop
// out.
__device__ __forceinline__ void topk_merge(const float* ld, const int* li, float* nd, int* ni,
                                           int k, const float* cd, const int* ci, int m,
                                           int sub, int g) {
  for (int i = sub; i < k; i += g) {
    const float d = ld[i];
    const int id = li[i];
    int r = i;
#pragma unroll 8
    for (int j = 0; j < m; ++j) r += key_less(cd[j], ci[j], d, id);
    if (r < k) {
      nd[r] = d;
      ni[r] = id;
    }
  }
  for (int j = sub; j < m; j += g) {
    const float d = cd[j];
    const int id = ci[j];
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(ld[mid], li[mid], d, id)) lo = mid + 1;
      else hi = mid;
    }
#pragma unroll 8
    for (int jj = 0; jj < m; ++jj) lo += key_less(cd[jj], ci[jj], d, id);
    if (lo < k) {
      nd[lo] = d;
      ni[lo] = id;
    }
  }
}

constexpr unsigned kFullMask = 0xffffffffu;

// The selection state of QT queries in shared memory: each query's threshold
// (its list's k-th pair), queue length and current list buffer, its queue of
// up to `cap` candidates (one step's), and two list buffers of k.
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
    topk_init(ld(q, 0), li(q, 0), k, sub, g);
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
    if (!__any_sync(kFullMask, m > 0)) return;
    const int b = cur[q];
    if (m > 0)
      topk_merge(ld(q, b), li(q, b), ld(q, 1 - b), li(q, 1 - b), k, cand_d + q * cap,
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
  if (first) group_bound(d, j, k, lane, bd, bi);
  if (!live) return;
  const float td = sel.thr_d[q];
  const int ti = sel.thr_i[q];
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    if (ok[u] && !key_less(bd, bi, d[u], j[u])) sel.offer(q, d[u], j[u], td, ti);
  }
}

// -- lists in registers ---------------------------------------------------------

// An empty list of KMAX pairs.
template <int KMAX>
__device__ __forceinline__ void list_init(float (&ld)[KMAX], int (&li)[KMAX]) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    ld[i] = INFINITY;
    li[i] = INT_MAX;
  }
}

// Insert (d, j) into a thread's sorted list of KMAX pairs if it comes before
// the last (the lexicographic (dist, idx) order; an empty slot holds
// (INF, INT_MAX)). Every entry is compared with the candidate at once and
// then moves or stays, so an insertion is one compare and one select deep,
// not a chain of KMAX compare-and-swaps.
template <int KMAX>
__device__ __forceinline__ void list_insert(float (&ld)[KMAX], int (&li)[KMAX], float d, int j) {
  if (!key_less(d, j, ld[KMAX - 1], li[KMAX - 1])) return;
  bool before[KMAX];  // entry i stays ahead of the candidate
#pragma unroll
  for (int i = 0; i < KMAX; ++i) before[i] = key_less(ld[i], li[i], d, j);
#pragma unroll
  for (int i = KMAX - 1; i > 0; --i) {
    if (!before[i]) {
      ld[i] = before[i - 1] ? d : ld[i - 1];
      li[i] = before[i - 1] ? j : li[i - 1];
    }
  }
  if (!before[0]) {
    ld[0] = d;
    li[0] = j;
  }
}

// The k smallest pairs of the sorted lists of a segment of P lanes (P a
// power of two, at most 32; the lists' indices distinct across the
// segment): k rounds, each the segment's least head by shuffles, popped by
// the lane that holds it. Lane r % P of the segment (`sub`) writes pair r's
// index to out[r]. Every lane of the warp calls it with the same k and P.
template <int KMAX>
__device__ __forceinline__ void merge_lists(float (&ld)[KMAX], int (&li)[KMAX], int k, int sub,
                                            int P, int* out) {
  for (int r = 0; r < k; ++r) {
    float m = ld[0];
    int mi = li[0];
    for (int off = P / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(kFullMask, m, off, P);
      const int oi = __shfl_xor_sync(kFullMask, mi, off, P);
      if (key_less(om, oi, m, mi)) {
        m = om;
        mi = oi;
      }
    }
    if (li[0] == mi && ld[0] == m) {  // the owner pops its head
#pragma unroll
      for (int i = 0; i < KMAX - 1; ++i) {
        ld[i] = ld[i + 1];
        li[i] = li[i + 1];
      }
      ld[KMAX - 1] = INFINITY;
      li[KMAX - 1] = INT_MAX;
    }
    if (sub == (r & (P - 1))) out[r] = mi;
  }
}

}  // namespace mpa
