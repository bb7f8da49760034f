// fps_kernel: farthest point sampling, the whole npoint-step chain in one
// launch.
//
// Replaces mpa_tpu/ops/pallas/fps_pallas.py::farthest_point_sample_pallas
// (kernel body _fps_kernel). Contract (the XLA loop of mpa_tpu/ops/fps.py):
// points [B,N,C] f32 -> [B,npoint] int32; out[:, i] = last is recorded before
// the update; the distance to the last pick is the direct difference
// sum_c (p_c - last_c)^2 in channel order, separately rounded; the running
// minimum starts at +inf; the argmax takes the first maximum.
//
// What bounds it on the H100: the npoint steps depend on each other, so the
// time is npoint block-wide argmax rounds, each a few shared-memory and
// shuffle latencies; bytes and operations are tiny. Design: one block per
// batch element (the TPU kernel's single program over the whole batch is a
// TPU constraint and is not copied); the cloud sits in shared memory, each
// thread keeps the running minimum of its ITEMS points in registers, and each
// step reduces (value, -index) across the block with warp shuffles and one
// round through shared memory, so ties go to the first maximum.
#include "common.cuh"

namespace {

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int ITEMS>
__device__ __forceinline__ void fps_body(const float* __restrict__ points, int* __restrict__ out,
                                         int N, int C, int npoint, int start) {
  extern __shared__ float p_s[];  // [N][C]
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int last_s;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarps = (blockDim.x + 31) >> 5;
  const float* pb = points + static_cast<size_t>(b) * N * C;
  for (int e = t; e < N * C; e += blockDim.x) p_s[e] = pb[e];

  float mind[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) mind[it] = INFINITY;
  __syncthreads();

  int last = start;
  int* ob = out + static_cast<size_t>(b) * npoint;
  for (int i = 0; i < npoint; ++i) {
    if (t == 0) ob[i] = last;
    const float* lp = p_s + last * C;
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int j = t + it * blockDim.x;
      if (j < N) {
        const float* pj = p_s + j * C;
        float dx = __fsub_rn(pj[0], lp[0]);
        float d = __fmul_rn(dx, dx);
        for (int c = 1; c < C; ++c) {
          dx = __fsub_rn(pj[c], lp[c]);
          d = __fadd_rn(d, __fmul_rn(dx, dx));
        }
        const float m = fminf(mind[it], d);
        mind[it] = m;
        if (m > bv) {  // j increases with it: keeps this thread's first maximum
          bv = m;
          bi = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      better(bv, bi, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? red_v[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        better(bv, bi, ov, oi);
      }
      if (lane == 0) last_s = bi;
    }
    __syncthreads();
    last = last_s;
  }
}

template <int ITEMS>
__global__ void fps_kernel(const float* __restrict__ points, int* __restrict__ out, int N, int C,
                           int npoint, int start) {
  fps_body<ITEMS>(points, out, N, C, npoint, start);
}

// 16 points a thread asks for more than the 64 registers a thread that 1024
// threads may have; the bound makes ptxas fit them. The narrower forms fit
// without it and keep their own allocation.
__global__ void __launch_bounds__(1024) fps_kernel_16(const float* __restrict__ points,
                                                      int* __restrict__ out, int N, int C,
                                                      int npoint, int start) {
  fps_body<16>(points, out, N, C, npoint, start);
}

using FpsKernel = void (*)(const float*, int*, int, int, int, int);

template <int ITEMS>
cudaError_t launch(const float* points, int* out, int B, int N, int C, int npoint,
                   int start, cudaStream_t stream, FpsKernel kernel = fps_kernel<ITEMS>) {
  int threads = mpa::ceil_div(N, ITEMS);
  threads = mpa::ceil_div(threads, 32) * 32;
  const size_t smem = sizeof(float) * static_cast<size_t>(N) * C;
  cudaError_t err = mpa::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, stream>>>(points, out, N, C, npoint, start);
  return cudaGetLastError();
}

}  // namespace

// points [B,N,C] f32 contiguous -> out [B,npoint] int32. Requires
// N <= 16384 (1024 threads of 16 points), N*C*4 bytes within shared memory
// (a 3-channel 16384-point cloud takes 192 KB), 0 <= start < N and
// npoint <= N (checked by the Python wrapper).
MPA_EXPORT int mpa_fps(const void* points, void* out, int B, int N, int C, int npoint,
                       int start, void* stream) {
  auto pp = static_cast<const float*>(points);
  auto op = static_cast<int*>(out);
  cudaStream_t st = mpa::as_stream(stream);
  if (N <= 1024) return launch<1>(pp, op, B, N, C, npoint, start, st);
  if (N <= 2048) return launch<2>(pp, op, B, N, C, npoint, start, st);
  if (N <= 4096) return launch<4>(pp, op, B, N, C, npoint, start, st);
  if (N <= 8192) return launch<8>(pp, op, B, N, C, npoint, start, st);
  return launch<16>(pp, op, B, N, C, npoint, start, st, fps_kernel_16);
}
