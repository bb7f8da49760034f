// scatter_mean_kernel: scatter-mean upsample, the decoder's coarse -> fine move.
//
// Replaces mpa_tpu/ops/pallas/scatter_pallas.py::_scatter_sum_count (kernel
// body _scatter_kernel) and the divide of ::scatter_mean_upsample_pallas.
// Contract: feat [B,S,C] f32, idx [B,S,K] int32 -> out [B,N,C] f32 and
// count [B,N] f32. Every coarse point s adds its row to the K fine slots
// idx[b,s,:]; count[b,n] is the number of (s,k) with idx[b,s,k] == n (a slot
// named twice by one coarse point counts twice); out[b,n] = sum /
// max(count, 1), so an unclaimed slot is zero. An index outside [0, N) claims
// no slot. Each slot's sum is taken in ascending (s, k) order from 0, the
// order in which a sequential index_add_ visits the claims, so the result has
// no run-to-run difference and equals the plain version on the CPU bit for
// bit; atomicAdd into the slots would land in no fixed order, and the
// feature-space kNN downstream turns last bits into other neighbours.
//
// What bounds it on the H100: bytes (feat and idx read once, out and count
// written once; one add per claimed row float). Design: a block owns a
// range of `slots` consecutive slots of one cloud and builds the inverse
// index of its range in shared memory, so that finding a slot's claims costs
// about S*K compares a block, not a slot. It reads the cloud's S*K indices in
// passes of up to kMaxTile into shared memory, gives each warp a contiguous
// segment of the pass, and:
//   1. counts the claims of each slot in each warp's segment (shared integer
//      atomics; exact, and summed over the passes they are `count`) and
//      compacts the segment's claims in order (four indices a lane and four
//      ballots a step);
//   2. takes a block-wide exclusive scan of the counts, slot-major and
//      warp-minor, which gives every (slot, warp) its place in the list;
//   3. each warp writes its claims' coarse rows s at their (slot, warp)
//      cursors, 32 claims at once (__match_any_sync ranks a step's claims of
//      one slot), so every slot's list is in ascending (s, k) order with no
//      sort;
//   4. adds each slot's rows in list order, G lanes a slot across the
//      channels (float4 where `vec` is 4), into `out`: the sum of a pass
//      before the last is kept in `out` and read back by the same thread.
// One launch, no float atomics, a list that never overflows (a pass holds
// at most as many claims as indices). The design before this one gave each
// slot a warp that compared every one of the cloud's S*K indices with it:
// B*N*S*K compares a launch. The TPU's one-hot mask^T @ f matmuls, the bf16
// hi/lo split and the lane-padded count tile answer the TPU's serial scatter
// and VMEM limit and are not carried over.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = kThreads;  // one slot a thread in the scan
constexpr int kMaxTile = 4096;       // indices a pass: 32 KB of shared memory with the list

template <int VEC>
struct Row {
  float x[VEC];
};

template <int VEC>
__device__ __forceinline__ Row<VEC> load_row(const float* p) {
  Row<VEC> r;
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    r.x[0] = v.x;
    r.x[1] = v.y;
    r.x[2] = v.z;
    r.x[3] = v.w;
  } else {
    r.x[0] = __ldg(p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void add_row(Row<VEC>& acc, const Row<VEC>& r) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc.x[i] = __fadd_rn(acc.x[i], r.x[i]);
}

// The block's exclusive prefix of x in thread order. warp_sums: kWarps ints,
// free until the block's next __syncthreads.
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

// Grid (ceil(N / slots), B); dynamic shared memory: 2 * tile ints.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_mean_kernel(const float* __restrict__ feat, const int* __restrict__ idx,
                    float* __restrict__ out, float* __restrict__ count, int S, int K, int N,
                    int C, int slots, int tile) {
  extern __shared__ int4 smem4[];
  int* stage = reinterpret_cast<int*>(smem4);  // [tile]: the pass's indices
  int* list = stage + tile;  // [tile]: the claiming coarse rows, grouped by slot
  __shared__ int cursor[kWarps][kMaxSlots];  // claims of (warp, slot), then its write cursor
  __shared__ int first[kMaxSlots + 1];       // each slot's list in this pass: [first, first+1)
  __shared__ int claims[kMaxSlots];          // each slot's claims over the passes
  __shared__ int warp_sums[kWarps];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * slots;
  const unsigned nr = static_cast<unsigned>(min(slots, N - n0));
  const int E = S * K;
  const int* ib = idx + static_cast<size_t>(b) * E;
  const float* fb = feat + static_cast<size_t>(b) * S * C;
  float* ob = out + (static_cast<size_t>(b) * N + n0) * C;
  // Lanes a slot in the adds: the least power of two that covers the row's
  // VEC-wide columns, at most 32.
  int G = 1;
  while (G < 32 && G * VEC < C) G *= 2;

  claims[tid] = 0;
  for (int p0 = 0;; p0 += tile) {
    const int len = min(tile, E - p0);  // 0 when S == 0: one pass that writes zeros
    const bool last = p0 + tile >= E;
    const int seg = mpa::ceil_div(mpa::ceil_div(max(len, 1), kWarps), 4) * 4;  // whole int4s
    const int lo = min(warp * seg, len), hi = min(lo + seg, len);
    // 1. Stage the pass, then count the claims of each warp's segment a
    //    slot.
    for (int s = tid; s < kWarps * static_cast<int>(nr); s += kThreads)
      cursor[s / nr][s % nr] = 0;
#pragma unroll 8
    for (int i = tid; i < len; i += kThreads) stage[i] = __ldg(ib + p0 + i);
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
          atomicAdd(&cursor[warp][slot[j]], 1);
          stage[lo + pos++] = (i + j) << 8 | slot[j];
        }
      }
    }
    __syncthreads();
    // 2. Slot-major, warp-minor exclusive scan: thread t owns slot t.
    int tot = 0;
    if (tid < static_cast<int>(nr)) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = cursor[w][tid];
        cursor[w][tid] = tot;
        tot += c;
      }
    }
    const int base = block_exclusive_scan(tot, warp_sums);
    if (tid < static_cast<int>(nr)) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) cursor[w][tid] += base;
      first[tid] = base;
      claims[tid] += tot;
      if (tid == static_cast<int>(nr) - 1) first[nr] = base + tot;
    }
    __syncthreads();
    // 3. Each warp writes its claims' coarse rows at their (slot, warp)
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
        list[cursor[warp][slot] + rank] = (p0 + (claim >> 8)) / K;
        __syncwarp(valid);
        if (rank == 0) cursor[warp][slot] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();
    // 4. Add each slot's rows in list order; G lanes a slot.
    const int g = lane % G;
    for (int slot = tid / G; slot < static_cast<int>(nr); slot += kThreads / G) {
      const int j0 = first[slot], j1 = first[slot + 1];
      const float den = fmaxf(static_cast<float>(claims[slot]), 1.f);
      for (int c = g * VEC; c < C; c += G * VEC) {
        float* o = ob + static_cast<size_t>(slot) * C + c;
        Row<VEC> acc;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc.x[v] = p0 == 0 ? 0.f : o[v];
        int j = j0;
        for (; j + 4 <= j1; j += 4) {  // four rows' loads in flight, added in order
          const Row<VEC> r0 = load_row<VEC>(fb + static_cast<size_t>(list[j]) * C + c);
          const Row<VEC> r1 = load_row<VEC>(fb + static_cast<size_t>(list[j + 1]) * C + c);
          const Row<VEC> r2 = load_row<VEC>(fb + static_cast<size_t>(list[j + 2]) * C + c);
          const Row<VEC> r3 = load_row<VEC>(fb + static_cast<size_t>(list[j + 3]) * C + c);
          add_row(acc, r0);
          add_row(acc, r1);
          add_row(acc, r2);
          add_row(acc, r3);
        }
        for (; j < j1; ++j) add_row(acc, load_row<VEC>(fb + static_cast<size_t>(list[j]) * C + c));
        if (last) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc.x[v] = __fdiv_rn(acc.x[v], den);
        }
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(o) = make_float4(acc.x[0], acc.x[1], acc.x[2], acc.x[3]);
        } else {
          *o = acc.x[0];
        }
      }
    }
    if (last) break;
    __syncthreads();  // the pass's shared arrays are used up
  }
  if (tid < static_cast<int>(nr))
    count[static_cast<size_t>(b) * N + n0 + tid] = static_cast<float>(claims[tid]);
}

}  // namespace

// feat [B,S,C] f32, idx [B,S,K] int32, out [B,N,C] f32, count [B,N] f32, all
// contiguous. Requires B <= 65535, S*K < 2^31 and C >= 1 (checked by the
// Python wrapper). slots: a block's range of slots, 1..256; vec: channels a
// lane, 4 (C % 4 == 0, feat and out 16-byte aligned) or 1
// (ops/scatter.py::scatter_mean_form picks both); any other is refused with
// cudaErrorInvalidValue.
MPA_EXPORT int mpa_scatter_mean(const void* feat, const void* idx, void* out, void* count,
                                int B, int S, int K, int N, int C, int slots, int vec,
                                void* stream) {
  if (B == 0 || N == 0) return cudaGetLastError();
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (slots < 1 || slots > kMaxSlots ||
      !(vec == 1 || (vec == 4 && C % 4 == 0 && !misaligned(feat) && !misaligned(out))))
    return cudaErrorInvalidValue;
  const int E = S * K;
  const int tile = E >= kMaxTile ? kMaxTile : max(mpa::ceil_div(E, 32) * 32, 32);
  // At most 32 KB with the 10 KB of static arrays: under the 48 KB a
  // launch gets without an opt-in.
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(tile);
  auto kernel = vec == 4 ? scatter_mean_kernel<4> : scatter_mean_kernel<1>;
  dim3 grid(mpa::ceil_div(N, slots), B);
  kernel<<<grid, kThreads, smem, mpa::as_stream(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int*>(idx), static_cast<float*>(out),
      static_cast<float*>(count), S, K, N, C, slots, tile);
  return cudaGetLastError();
}
