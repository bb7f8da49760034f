// fps_kernel: farthest point sampling, the whole npoint-step chain in one
// launch, one cloud spread over a thread-block cluster.
//
// Replaces mpa_tpu/ops/pallas/fps_pallas.py::farthest_point_sample_pallas
// (kernel body _fps_kernel), and the XLA loop of mpa_tpu/ops/fps.py that
// runs above C = 16 (feature clouds). Contract: points [B,N,C] f32 and one
// start per cloud, start [B] int32 in [0, N) (or null: every cloud starts
// at start0) -> [B,npoint] int32;
// out[:, i] = last is recorded before the update; the distance to the last
// pick is the direct difference sum_c (p_c - last_c)^2 in channel order,
// separately rounded; the running minimum starts at +inf; the argmax takes
// the first maximum.
//
// What bounds it on the H100: the npoint steps depend on each other, so the
// time is npoint rounds of (distances, argmax across the cloud, the pick's
// coordinates); bytes and operations are tiny. A round is latency: a warp
// reduction, a barrier, a second reduction, a shared-memory load.
//
// Design. One cluster of `cs` CTAs per cloud (cs = 1 is a plain block), each
// CTA owning a slice of ceil(N / cs) points, so that a large cloud's
// distance work spreads over cs SMs. Each step:
//   1. every thread updates its points' running minima and keeps its first
//      maximum; the warp takes its first maximum with two redux.sync
//      (maximum of the value's bits, which order as the values do for the
//      non-negative minima, then the least index among the lanes at it);
//   2. the warp's candidate goes into slot [step & 1][rank * warps + warp]
//      of every CTA: in a block, one store and __syncthreads; in a cluster,
//      lanes 0..cs-1 push it with st.async into every CTA's slot, counted
//      in bytes on that CTA's mbarrier, and each CTA waits on its own
//      mbarrier alone (a cluster-wide barrier.cluster round measured about
//      0.45 us more than __syncthreads on an H100; PERF.md section 6);
//   3. every warp reduces all the slots itself (the same two redux.sync),
//      so no second barrier hands the winner round;
//   4. the winner's coordinates come from shared memory.
// The slots are double-buffered: a CTA writes a buffer again two steps on,
// only after it has every CTA's candidate of the step between, which each
// sends after reading the buffer. Two forms, fixed by the shape (fps_form
// in ops/fps.py; mpa_fps refuses any form fps_form does not pick):
//   - resident (C == 3): each CTA holds the whole cloud in shared memory, for
//     step 4, and its own points' coordinates and minima in registers (PPT
//     points a thread, templated);
//   - sliced (any C): each CTA holds only its slice, channel-major, and its
//     minima in shared memory; every warp copies the winner's row from the
//     owning CTA's slice into its own buffer (a distributed shared-memory
//     read of a read-only slice, so no second barrier), and a last cluster
//     barrier keeps every slice alive until no CTA reads it.
// A point past the cloud's end holds minimum 0 and never wins: the first
// maximum is the least index among the largest values, and a real point
// with a lower index always exists. `chain` instantiations skip the
// distance work and keep the rest of the step, so that their time is npoint
// rounds: the floor this chain of steps can reach.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // the index of a candidate holding no point
constexpr int kMaxSlots = 64;            // cs * warps
constexpr int kMaxCluster = 16;

// Threads a resident block may have at PPT points a thread: PPT x 4 floats
// in registers, so that ptxas keeps them there.
constexpr int max_threads(int ppt) { return ppt <= 4 ? 1024 : 4096 / ppt; }

// The first maximum over the warp: the largest value bits, then the least
// index among the lanes that hold them.
__device__ __forceinline__ uint2 warp_first_max(unsigned v, unsigned i) {
  const unsigned m = __reduce_max_sync(kFull, v);
  return make_uint2(m, __reduce_min_sync(kFull, v == m ? i : kNone));
}

__device__ __forceinline__ uint2 first_max(uint2 a, uint2 b) {
  return (b.x > a.x || (b.x == a.x && b.y < a.y)) ? b : a;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory word in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// The candidates of a step: slots [2][cs * warps], double-buffered, and for
// a cluster one mbarrier a buffer, whose phase completes when this CTA has
// armed it and every warp of the cluster has pushed its candidate in.
struct Exchange {
  uint2 slots[2][kMaxSlots];
  unsigned long long bars[2];
};

__device__ __forceinline__ void init_exchange(Exchange& ex) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&ex.bars[j]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Steps 2-3 (see the header): hand the warp's candidate to every CTA, wait
// for every warp's, and take the first maximum over them.
template <bool kCluster>
__device__ __forceinline__ unsigned exchange(Exchange& ex, int step, uint2 w, int cs, int rank,
                                             int nw, int warp, int lane) {
  const int buf = step & 1, nslots = cs * nw;
  uint2* mine = &ex.slots[buf][rank * nw + warp];
  if constexpr (kCluster) {
    const uint32_t bar = smem_addr(&ex.bars[buf]);
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(nslots * 8)
                   : "memory");
    if (lane < cs)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];\n" ::
              "r"(in_rank(smem_addr(mine), lane)),
          "r"(w.x), "r"(w.y), "r"(in_rank(bar, lane))
          : "memory");
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(bar),
        "r"((step >> 1) & 1)
        : "memory");
  } else {
    if (lane == 0) *mine = w;
    __syncthreads();
  }
  const uint2* s = ex.slots[buf];
  uint2 c = lane < nslots ? s[lane] : make_uint2(0u, kNone);
  if (nslots > 32 && lane + 32 < nslots) c = first_max(c, s[lane + 32]);
  return warp_first_max(c.x, c.y).y;
}

// The resident form: C == 3, the whole cloud in each CTA's shared memory.
template <int PPT, bool kCluster, bool kChain>
__global__ void __launch_bounds__(max_threads(PPT))
fps_kernel(const float* __restrict__ points, const int* __restrict__ start, int start0,
           int* __restrict__ out, int N, int npoint) {
  extern __shared__ float cloud_s[];  // [N][3]
  __shared__ Exchange ex;
  int cs = 1, rank = 0;
  if constexpr (kCluster) {
    cs = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int b = blockIdx.x / cs;
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = T >> 5;
  const float* pb = points + static_cast<size_t>(b) * N * 3;
  for (int e = t; e < N * 3; e += T) cloud_s[e] = pb[e];
  const int L = mpa::ceil_div(N, cs), lo = rank * L, hi = min(lo + L, N);
  if constexpr (kCluster) {
    init_exchange(ex);
    cluster_barrier();  // the cloud is staged, the mbarriers set, and every CTA runs
  } else {
    __syncthreads();
  }

  float x[PPT], y[PPT], z[PPT], mind[PPT];
#pragma unroll
  for (int it = 0; it < PPT; ++it) {
    const int j = lo + t + it * T;
    const bool real = j < hi;
    x[it] = real ? cloud_s[3 * j] : 0.f;
    y[it] = real ? cloud_s[3 * j + 1] : 0.f;
    z[it] = real ? cloud_s[3 * j + 2] : 0.f;
    mind[it] = real ? INFINITY : 0.f;
  }
  const unsigned first = lo + t < hi ? static_cast<unsigned>(lo + t) : kNone;

  int last = start ? start[b] : start0;
  int* ob = out + static_cast<size_t>(b) * npoint;
  for (int i = 0;; ++i) {
    if (rank == 0 && t == 0) ob[i] = last;
    if (i + 1 == npoint) break;
    const float lx = cloud_s[3 * last], ly = cloud_s[3 * last + 1], lz = cloud_s[3 * last + 2];
    unsigned bv = 0u, bi = first;
    if constexpr (kChain) {
      bv = __float_as_uint(fmaxf(mind[0], __fmul_rn(lx, 0.f)));
    } else {
#pragma unroll
      for (int it = 0; it < PPT; ++it) {
        float dx = __fsub_rn(x[it], lx);
        float d = __fmul_rn(dx, dx);
        dx = __fsub_rn(y[it], ly);
        d = __fadd_rn(d, __fmul_rn(dx, dx));
        dx = __fsub_rn(z[it], lz);
        d = __fadd_rn(d, __fmul_rn(dx, dx));
        const float m = fminf(mind[it], d);
        mind[it] = m;
        const unsigned mb = __float_as_uint(m);
        if (it == 0) {
          bv = mb;
        } else if (mb > bv) {  // j grows with it: keeps the thread's first maximum
          bv = mb;
          bi = static_cast<unsigned>(lo + t + it * T);
        }
      }
    }
    last = static_cast<int>(
        exchange<kCluster>(ex, i, warp_first_max(bv, bi), cs, rank, nw, warp, lane));
  }
}

// The sliced form: any C; each CTA holds its slice [C][L] and its minima [L]
// in shared memory, and each warp a copy of the last pick's row.
template <bool kCluster, bool kChain>
__global__ void __launch_bounds__(1024)
fps_slice_kernel(const float* __restrict__ points, const int* __restrict__ start, int start0,
                 int* __restrict__ out, int N, int C, int npoint) {
  extern __shared__ float smem[];
  __shared__ Exchange ex;
  int cs = 1, rank = 0;
  if constexpr (kCluster) {
    cs = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int b = blockIdx.x / cs;
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5, nw = T >> 5;
  const int L = mpa::ceil_div(N, cs), lo = rank * L, n = max(min(L, N - lo), 0);
  float* slice_s = smem;                                       // [C][L]
  float* mind_s = slice_s + static_cast<size_t>(C) * L;        // [L]
  float* last_s = mind_s + L + static_cast<size_t>(warp) * C;  // [nw][C], this warp's row
  const float* pb = points + (static_cast<size_t>(b) * N + lo) * C;
  for (int e = t; e < n * C; e += T) {
    const int p = e / C, c = e - p * C;
    slice_s[static_cast<size_t>(c) * L + p] = pb[e];
  }
  for (int p = t; p < L; p += T) mind_s[p] = p < n ? INFINITY : 0.f;
  if constexpr (kCluster) {
    init_exchange(ex);
    cluster_barrier();
  } else {
    __syncthreads();
  }

  // The row of cloud point j, from the slice of the CTA that holds it.
  auto fetch_row = [&](int j) {
    const int owner = j / L, p = j - owner * L;
    const float* src = slice_s;
    if constexpr (kCluster) src = cg::this_cluster().map_shared_rank(slice_s, owner);
    for (int c = lane; c < C; c += 32) last_s[c] = src[static_cast<size_t>(c) * L + p];
    __syncwarp();
  };

  int last = start ? start[b] : start0;
  fetch_row(last);
  int* ob = out + static_cast<size_t>(b) * npoint;
  for (int i = 0;; ++i) {
    if (rank == 0 && t == 0) ob[i] = last;
    if (i + 1 == npoint) break;
    unsigned bv = 0u, bi = kNone;
    if constexpr (kChain) {
      if (t < n) {
        bv = __float_as_uint(fmaxf(mind_s[t], __fmul_rn(last_s[0], 0.f)));
        bi = static_cast<unsigned>(lo + t);
      }
    } else {
      for (int p = t; p < n; p += T) {
        float dx = __fsub_rn(slice_s[p], last_s[0]);
        float d = __fmul_rn(dx, dx);
        for (int c = 1; c < C; ++c) {
          dx = __fsub_rn(slice_s[static_cast<size_t>(c) * L + p], last_s[c]);
          d = __fadd_rn(d, __fmul_rn(dx, dx));
        }
        const float m = fminf(mind_s[p], d);
        mind_s[p] = m;
        const unsigned mb = __float_as_uint(m);
        if (bi == kNone || mb > bv) {  // p grows: keeps the thread's first maximum
          bv = mb;
          bi = static_cast<unsigned>(lo + p);
        }
      }
    }
    __syncwarp();  // every lane has read last_s before it is overwritten
    last = static_cast<int>(
        exchange<kCluster>(ex, i, warp_first_max(bv, bi), cs, rank, nw, warp, lane));
    fetch_row(last);
  }
  if constexpr (kCluster) cluster_barrier();  // no CTA leaves while another reads its slice
}

using FpsKernel = void (*)(const float*, const int*, int, int*, int, int);
using SliceKernel = void (*)(const float*, const int*, int, int*, int, int, int);

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem, int cs,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = mpa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (cs == 1) {
    kernel<<<blocks, threads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  if (cs > 8) {
    err = mpa::allow_attribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int PPT>
FpsKernel resident(bool cluster, bool chain) {
  if (cluster) return chain ? fps_kernel<PPT, true, true> : fps_kernel<PPT, true, false>;
  return chain ? fps_kernel<PPT, false, true> : fps_kernel<PPT, false, false>;
}

}  // namespace

// points [B,N,C] f32 contiguous, start [B] int32 in [0, N) or null (every
// cloud starts at start0) -> out [B,npoint] int32, 1 <= npoint <= N. The
// form is fps_form's in ops/fps.py: `resident` for C == 3 with the cloud in
// each CTA's shared memory, on one block of 1-16 warps or a cluster of 4 or
// 8 CTAs of 4 warps (ceil(N / cs) points a CTA, at most 32 a thread,
// rounded up to a power of two, and at most max_threads of them a block);
// else the sliced form, 1-16 CTAs of 8 warps up to 2 CTAs and 4 from 4.
// `chain` skips the distance work (a measurement of the rounds, not the
// function). Returns cudaErrorInvalidValue for any other form and the
// launch's error for one the card refuses.
MPA_EXPORT int mpa_fps(const void* points, const void* start, int start0, void* out, int B,
                       int N, int C, int npoint, int cs, int nw, int resident_form, int chain,
                       void* stream) {
  auto pp = static_cast<const float*>(points);
  auto sp = static_cast<const int*>(start);
  auto op = static_cast<int*>(out);
  cudaStream_t st = mpa::as_stream(stream);
  if (B == 0) return cudaGetLastError();
  const bool form_ok =
      resident_form ? C == 3 && (cs == 1 ? nw <= 16 : (cs == 4 || cs == 8) && nw == 4)
                    : (cs & (cs - 1)) == 0 && cs <= kMaxCluster && nw == (cs <= 2 ? 8 : 4);
  if (!form_ok || cs < 1 || nw < 1 || npoint < 1 || npoint > N ||
      (!start && (start0 < 0 || start0 >= N)))
    return cudaErrorInvalidValue;
  const int L = mpa::ceil_div(N, cs), threads = 32 * nw, blocks = B * cs;
  if (!resident_form) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(C) * L + L + static_cast<size_t>(nw) * C);
    SliceKernel k = cs > 1 ? (chain ? fps_slice_kernel<true, true> : fps_slice_kernel<true, false>)
                           : (chain ? fps_slice_kernel<false, true> : fps_slice_kernel<false, false>);
    return launch(k, blocks, threads, smem, cs, st, pp, sp, start0, op, N, C, npoint);
  }
  int ppt = 1;
  while (ppt < 32 && ppt * threads < L) ppt *= 2;
  if (ppt * threads < L || threads > max_threads(ppt)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * static_cast<size_t>(N);
  const bool cl = cs > 1, ch = chain != 0;
  const FpsKernel k = ppt == 1   ? resident<1>(cl, ch)
                      : ppt == 2 ? resident<2>(cl, ch)
                      : ppt == 4 ? resident<4>(cl, ch)
                      : ppt == 8 ? resident<8>(cl, ch)
                      : ppt == 16 ? resident<16>(cl, ch)
                                  : resident<32>(cl, ch);
  return launch(k, blocks, threads, smem, cs, st, pp, sp, start0, op, N, npoint);
}
