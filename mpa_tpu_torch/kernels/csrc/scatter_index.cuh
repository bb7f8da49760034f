// The inverse-index body shared by the three kernels that move rows into
// slots: scatter_mean_kernel (scatter_mean.cu), windowed_scatter_mean_kernel
// (window_scatter_mean.cu) and scatter_add_rows_kernel (scatter_add.cu).
//
// The function: claim e of a cloud (e in [e_lo, e_hi) of its flattened
// claims) names slot idx[e] and brings source row e / K (K claims a row: the
// scatter-mean's K neighbours, 1 for the scatter-add). Each slot of the
// block's range [n0, n0 + nr) gets the sum of its claims' rows, taken in
// ascending e from 0, the order in which a sequential index_add_ visits
// them, so the result equals the plain version on the CPU bit for bit.
// A claim that names no slot of [0, N) adds nothing. Epilogues: MEAN divides
// by max(claims, 1) and writes the claims as `count`; the sum writes the sum
// alone. Every slot of the range is written once: zero where nothing lands.
// Storage: f32 rows into f32 slots, or bf16 rows into bf16 slots; the sums
// are f32 either way, and a bf16 slot is rounded once, from the final f32
// sum (or mean), as the TPU kernels' f32 accumulators are cast once
// (mpa_tpu/ops/scatter.py:46-51, gather_pallas.py:332).
//
// Design: a block owns `slots` consecutive slots of one cloud and builds the
// inverse index of its range in shared memory, so that finding a slot's
// claims costs about (e_hi - e_lo) compares a block, not a slot. It reads
// its claim range in passes of up to kMaxTile indices into shared memory,
// gives each warp a contiguous segment of the pass, and:
//   1. counts the claims of each slot in each warp's segment (shared integer
//      atomics; exact, and summed over the passes they are `count`) and
//      compacts the segment's claims in order (four indices a lane and four
//      ballots a step);
//   2. takes a block-wide exclusive scan of the counts, slot-major and
//      warp-minor, which gives every (slot, warp) its place in the list;
//   3. each warp writes its claims' source rows at their (slot, warp)
//      cursors, 32 claims at once (__match_any_sync ranks a step's claims of
//      one slot), so every slot's list is in ascending e order with no sort;
//   4. adds each slot's rows in list order, G lanes a slot across the
//      channels (`vec` channels a lane: float4, float2 or one float; bf16
//      rows take eight as one 16-byte load, four, two or one, and keep them
//      in registers as loaded, Bf16Lanes), four or eight rows' loads in
//      flight (index_depth), into `out`: the sum of a pass before the last
//      is kept in `out` (f32 slots) or in the f32 scratch `part` (bf16
//      slots) and read back by the same thread.
// No float atomics, no memset, a list that never overflows (a pass holds at
// most as many claims as indices).
#pragma once

#include "common.cuh"

namespace mpa {

constexpr int kIndexThreads = 256;
constexpr int kIndexWarps = kIndexThreads / 32;
constexpr int kMaxSlots = kIndexThreads;  // one slot a thread in the scan
constexpr int kIndexBlocks = 4;           // blocks an SM: at most 64 registers a thread
constexpr int kMaxTile = 4096;            // indices a pass: 32 KB of shared memory with the list

// The block's static shared arrays (10 KB).
struct IndexShared {
  int cursor[kIndexWarps][kMaxSlots];  // claims of (warp, slot), then its write cursor
  int first[kMaxSlots + 1];            // each slot's list in this pass: [first, first+1)
  int claims[kMaxSlots];               // each slot's claims over the passes
  int warp_sums[kIndexWarps];
};

// Indices a pass for a claim range of up to E indices; the launch's dynamic
// shared memory is 2 * tile ints (at most 32 KB, which with the 10 KB of
// static arrays stays under the 48 KB a launch gets without an opt-in).
inline int index_tile(int E) {
  return E >= kMaxTile ? kMaxTile : (E < 32 ? 32 : ceil_div(E, 32) * 32);
}

inline size_t index_smem(int tile) { return sizeof(int) * 2 * static_cast<size_t>(tile); }

// Rows of four channels a slot's adds keep in flight: 8 where the slots take
// six claims or more on average (long lists: repsurf's grouped features),
// else 4 (eight cost registers that short lists do not repay). Rows of one
// channel take 4: eight measured slower there.
inline int index_depth(long long claims, int N) { return claims >= 6LL * N ? 8 : 4; }

template <int VEC>
struct Row {
  float x[VEC];
  __device__ __forceinline__ float operator[](int i) const { return x[i]; }
};

// A source row's VEC channels as loaded: floats, or the bf16 words
// (Bf16Lanes), widened as they are added.
template <typename T, int VEC>
using RowLanes =
    typename std::conditional<std::is_same<T, float>::value, Row<VEC>, Bf16Lanes<VEC>>::type;

template <int VEC>
__device__ __forceinline__ Bf16Lanes<VEC> load_row(const bf16* p) {
  Bf16Lanes<VEC> r;
  r.load(p);
  return r;
}

template <int VEC>
__device__ __forceinline__ Row<VEC> load_row(const float* p) {
  Row<VEC> r;
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r.x[0] = v.x;
    r.x[1] = v.y;
    r.x[2] = v.z;
    r.x[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    r.x[0] = v.x;
    r.x[1] = v.y;
  } else {
    r.x[0] = __ldg(p);
  }
  return r;
}

template <int VEC, typename Lanes>
__device__ __forceinline__ void add_row(Row<VEC>& acc, const Lanes& r) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc.x[i] = __fadd_rn(acc.x[i], r[i]);
}

// The block's exclusive prefix of x in thread order. warp_sums: kIndexWarps
// ints, free until the block's next __syncthreads.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  return before + inc - x;
}

// One block's slots [n0, n0 + nr), 1 <= nr <= kMaxSlots, from the claims
// [e_lo, e_hi) of `idx` (the cloud's claims; claim e brings row e / K of
// `src`, rows of C values of type T, float or bf16). out: slot n0's row of
// the output, of type T; part (T = bf16 and more than one pass only): slot
// n0's row of an f32 scratch of the output's shape; count (MEAN only): slot
// n0's count. smem4: 2 * tile ints of dynamic shared memory. Launched with
// kIndexThreads threads.
template <int VEC, int DEPTH, bool MEAN, typename T>
__device__ __forceinline__ void scatter_rows(const T* __restrict__ src,
                                             const int* __restrict__ idx, int e_lo, int e_hi,
                                             int K, int n0, int nr_, int C, int tile,
                                             T* __restrict__ out, float* __restrict__ part,
                                             float* __restrict__ count, IndexShared& sh,
                                             int4* smem4) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  int* stage = reinterpret_cast<int*>(smem4);  // [tile]: the pass's indices
  int* list = stage + tile;  // [tile]: the claiming source rows, grouped by slot
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned nr = static_cast<unsigned>(nr_);
  // Lanes a slot in the adds: enough for the row's VEC-wide columns, at most
  // 32; threads past the last whole group of G idle there.
  const int G = min(ceil_div(C, VEC), 32);
  const int per_step = kIndexThreads / G;

  sh.claims[tid] = 0;
  for (int p0 = e_lo;; p0 += tile) {
    const int len = min(tile, e_hi - p0);  // 0 for an empty range: one pass that writes zeros
    const bool last = p0 + tile >= e_hi;
    const int seg = ceil_div(ceil_div(max(len, 1), kIndexWarps), 4) * 4;  // whole int4s
    const int lo = min(warp * seg, len), hi = min(lo + seg, len);
    // 1. Stage the pass, then count the claims of each warp's segment a
    //    slot.
    for (int s = tid; s < kIndexWarps * static_cast<int>(nr); s += kIndexThreads)
      sh.cursor[s / nr][s % nr] = 0;
#pragma unroll 8
    for (int i = tid; i < len; i += kIndexThreads) stage[i] = __ldg(idx + p0 + i);
    __syncthreads();
    // Each claim of the warp's segment is counted, and compacted in place
    // (its offset in the pass << 8 | its slot) in ascending order, four
    // indices a lane a step: a claim's place is never past the index it was
    // read from.
    int n_claims = 0;  // the warp's
    const unsigned below = (1u << lane) - 1u;
    for (int i0 = lo; i0 < hi; i0 += 128) {
      const int i = i0 + 4 * lane;
      const int4 v = i < hi ? reinterpret_cast<const int4*>(stage)[i / 4] : make_int4(0, 0, 0, 0);
      const int vs[4] = {v.x, v.y, v.z, v.w};
      unsigned slot[4], in[4];
      int pos = n_claims;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        slot[j] = i + j < hi ? static_cast<unsigned>(vs[j]) - static_cast<unsigned>(n0) : nr;
        in[j] = __ballot_sync(0xffffffffu, slot[j] < nr);
        pos += __popc(in[j] & below);
        n_claims += __popc(in[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (slot[j] < nr) {
          atomicAdd(&sh.cursor[warp][slot[j]], 1);
          stage[lo + pos++] = (i + j) << 8 | slot[j];
        }
      }
    }
    __syncthreads();
    // 2. Slot-major, warp-minor exclusive scan: thread t owns slot t.
    int tot = 0;
    if (tid < static_cast<int>(nr)) {
#pragma unroll
      for (int w = 0; w < kIndexWarps; ++w) {
        const int c = sh.cursor[w][tid];
        sh.cursor[w][tid] = tot;
        tot += c;
      }
    }
    const int base = block_exclusive_scan(tot, sh.warp_sums);
    if (tid < static_cast<int>(nr)) {
#pragma unroll
      for (int w = 0; w < kIndexWarps; ++w) sh.cursor[w][tid] += base;
      sh.first[tid] = base;
      sh.claims[tid] += tot;
      if (tid == static_cast<int>(nr) - 1) sh.first[nr] = base + tot;
    }
    __syncthreads();
    // 3. Each warp writes its claims' source rows at their (slot, warp)
    //    cursors, 32 at a time: a claim's place is its cursor plus the
    //    number of lower lanes with the same slot.
    for (int j0 = 0; j0 < n_claims; j0 += 32) {
      const int j = j0 + lane;
      const unsigned valid = __ballot_sync(0xffffffffu, j < n_claims);
      if (j < n_claims) {
        const int claim = stage[lo + j];
        const unsigned slot = claim & 255;
        const unsigned peers = __match_any_sync(valid, slot);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        list[sh.cursor[warp][slot] + rank] = (p0 + (claim >> 8)) / K;
        __syncwarp(valid);
        if (rank == 0) sh.cursor[warp][slot] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    // 4. Add each slot's rows in list order; G lanes a slot, DEPTH rows'
    //    loads in flight (the last group's missing rows neither loaded nor
    //    added).
    if (tid < per_step * G) {
      const int g = tid % G;
      for (int slot = tid / G; slot < static_cast<int>(nr); slot += per_step) {
        const int j0 = sh.first[slot], j1 = sh.first[slot + 1];
        for (int c = g * VEC; c < C; c += G * VEC) {
          // Where a pass before the last keeps its sums: the f32 slot
          // itself, or the f32 scratch for a bf16 slot.
          float* o;
          if constexpr (kF32) {
            o = out + static_cast<size_t>(slot) * C + c;
          } else {
            o = part + static_cast<size_t>(slot) * C + c;
          }
          Row<VEC> acc;
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc.x[v] = p0 == e_lo ? 0.f : o[v];
          for (int j = j0; j < j1; j += DEPTH) {
            RowLanes<T, VEC> r[DEPTH];
#pragma unroll
            for (int u = 0; u < DEPTH; ++u)
              if (j + u < j1) r[u] = load_row<VEC>(src + static_cast<size_t>(list[j + u]) * C + c);
#pragma unroll
            for (int u = 0; u < DEPTH; ++u)
              if (j + u < j1) add_row(acc, r[u]);
          }
          if (MEAN && last) {
            const float den = fmaxf(static_cast<float>(sh.claims[slot]), 1.f);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc.x[v] = __fdiv_rn(acc.x[v], den);
          }
          if (!kF32 && last) {
            store_bf16<VEC>(reinterpret_cast<bf16*>(out) + static_cast<size_t>(slot) * C + c,
                            acc.x);
          } else if constexpr (VEC == 8) {  // bf16 rows: a pass before the last into part
            reinterpret_cast<float4*>(o)[0] = make_float4(acc.x[0], acc.x[1], acc.x[2], acc.x[3]);
            reinterpret_cast<float4*>(o)[1] = make_float4(acc.x[4], acc.x[5], acc.x[6], acc.x[7]);
          } else if constexpr (VEC == 4) {
            *reinterpret_cast<float4*>(o) = make_float4(acc.x[0], acc.x[1], acc.x[2], acc.x[3]);
          } else if constexpr (VEC == 2) {
            *reinterpret_cast<float2*>(o) = make_float2(acc.x[0], acc.x[1]);
          } else {
            *o = acc.x[0];
          }
        }
      }
    }
    if (last) break;
    __syncthreads();  // the pass's shared arrays are used up
  }
  if (MEAN && tid < static_cast<int>(nr)) count[tid] = static_cast<float>(sh.claims[tid]);
}

}  // namespace mpa
