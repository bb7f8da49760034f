// Top-k selection against a threshold shared per query, in shared memory.
//
// Used by knn_kernel (knn.cu). Each query owns one sorted list of k
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

}  // namespace mpa
