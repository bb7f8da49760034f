// Register-resident k-smallest selection of windowed_knn_kernel
// (window_knn.cu): per-lane sorted lists, merged by the warp at the end.
// knn_kernel (knn.cu) selects with knn_topk.cuh instead.
#pragma once

#include "common.cuh"

namespace mpa {

// QPW query values from shared memory, one float4 load where QPW == 4.
template <int QPW>
__device__ __forceinline__ void load_q(const float* p, float (&q)[QPW]) {
  if constexpr (QPW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    q[0] = v.x;
    q[1] = v.y;
    q[2] = v.z;
    q[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < QPW; ++i) q[i] = p[i];
  }
}

// Insert (d, j) into the sorted (dist, idx) list of KMAX entries. Candidates
// reach a lane in increasing index, so a strict compare keeps ties in index
// order.
template <int KMAX>
__device__ __forceinline__ void insert(float (&bd)[KMAX], int (&bi)[KMAX], float d, int j) {
  if (!(d < bd[KMAX - 1])) return;  // an equal distance never beats a lower index
  float cd = d;
  int ci = j;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    const bool before = (cd < bd[i]) || (cd == bd[i] && ci < bi[i]);
    if (before) {
      const float td = bd[i];
      const int ti = bi[i];
      bd[i] = cd;
      bi[i] = ci;
      cd = td;
      ci = ti;
    }
  }
}

// One round of the warp merge of 32 lane lists: the lexicographic (dist, idx)
// minimum of the list heads, on every lane; the lane that holds it (base
// indices are unique to a lane) pops its head.
template <int KMAX>
__device__ __forceinline__ void pop_min(float (&bd)[KMAX], int (&bi)[KMAX], float& v, int& id) {
  v = bd[0];
  id = bi[0];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, id, off);
    if (ov < v || (ov == v && oi < id)) {
      v = ov;
      id = oi;
    }
  }
  if (bi[0] == id) {
#pragma unroll
    for (int j = 0; j < KMAX - 1; ++j) {
      bd[j] = bd[j + 1];
      bi[j] = bi[j + 1];
    }
    bd[KMAX - 1] = INFINITY;
    bi[KMAX - 1] = INT_MAX;
  }
}

}  // namespace mpa
