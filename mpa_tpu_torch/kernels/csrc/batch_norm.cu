// batch_norm_act_kernel and batch_norm_act_bwd_kernel: train-mode BatchNorm
// over the rows of a channel-last [R, C] float32 tensor, fused with the
// LeakyReLU(0.2) that follows it, forward and backward. The forward is five
// launches (batch_norm_sum_kernel for the mean and for the squared
// deviations, each followed by batch_norm_finish_kernel, then
// batch_norm_apply_kernel), the backward five (batch_norm_sum_kernel twice,
// each followed by batch_norm_finish_kernel, then batch_norm_grad_input_kernel).
//
// Replaces no TPU kernel: mpa_tpu's BatchNorm is flax's nn.BatchNorm
// (mpa_tpu/nn/linear.py), which XLA fuses with its activation by itself. It
// was added because in the port PyTorch ran the same arithmetic as about 18
// ops forward and 22 in autograd's backward, some 46 passes over the [R, C]
// tensor, and that glue set the pace of both training paths.
//
// Contract (flax's use_fast_variance=False, momentum 0.9), float32 throughout,
// every value rounded as the plain version (ops/batch_norm.py) rounds it on
// the card, so that the two agree bit for bit:
//   mean = sum(x) * (C / (R * C)); c = x - mean; var = sum(c * c) * (C / (R *
//   C)), from deviations, in two passes; r = rsqrt(var + eps); y = c * (r *
//   weight) + bias, a product and then a sum, each rounded (__fmul_rn,
//   __fadd_rn: no FMA); then LeakyReLU(0.2) where act; running = keep *
//   running + (1 - keep) * batch, with the biased var. The backward is
//   autograd's of those operations, step for step: gy = y > 0 ? dy : 0.2 * dy
//   (dy where !act); dbias = sum(gy); dweight = sum(gy * c) * r; with gsq =
//   (sum(gy * c) * weight * -0.5) * r^3 * (1 / R), gc = (gy * (r * weight) +
//   gsq * c) + gsq * c; dx = gc - sum(gc) * (1 / R).
//
// Each sum over the rows is taken in the order of PyTorch's own column
// reduction (ATen/native/cuda/Reduce.cuh, setReduceConfig and ReduceOp for a
// reduction over the rows of a contiguous tensor): each thread keeps four
// accumulators of vec channels over rows `step_input` apart and adds them in
// turn, the block's row groups add in a tree, and where the blocks of one
// column (ctas) split the rows, a second launch adds their partials, thread
// y taking blocks y, y + bh, ... and then the same tree.
// ops/batch_norm.py::reduce_config reproduces the shape PyTorch picks from R,
// C and the card's SM and thread counts. A shape PyTorch would cut up for
// 32-bit indexing (over 2^31 bytes) is summed in the same order uncut: as
// exact, though not PyTorch's bits.
//
// What bounds it on the H100: bytes. The forward reads x three times and
// writes y once, the backward reads dy and x three times each and writes dx:
// 44 * R * C bytes in all, against about 184 * R * C for the plain version's
// 46 passes. Only x and the per-channel mean and rstd are kept for the
// backward, which recomputes c, y and the activation's mask where it reads x.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kVt = 4;            // accumulators a thread keeps (PyTorch's vt0)
constexpr int kMaxThreads = 512;  // PyTorch's MAX_NUM_THREADS for float

// VEC consecutive floats of one row (4, 2 or 1), moved as one load or store.
template <int VEC>
struct Row {
  float v[VEC];

  __device__ __forceinline__ void load(const float* p) {
    if constexpr (VEC == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
    } else if constexpr (VEC == 2) {
      const float2 u = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = u.x;
      v[1] = u.y;
    } else {
      v[0] = __ldg(p);
    }
  }

  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (VEC == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      p[0] = v[0];
    }
  }
};

// PyTorch's reduction shape for [R, C] (ops/batch_norm.py::reduce_config):
// block (bw, bh), grid (ceil(C / vec / step_output), ctas). Thread (x, y) of
// block (c1, c2) owns channels (x + y * out_mult_y + c1 * step_output) * vec
// and rows y * in_mult_y + c2 * in_mult_cta, then step_input apart.
struct Config {
  int out_mult_y, step_output, in_mult_y, in_mult_cta, step_input, ctas;
};

struct Place {
  int ch, row;
  bool live;
};

template <int VEC>
__device__ __forceinline__ Place place(const Config& k, int R, int C) {
  Place p;
  p.ch = (threadIdx.x + threadIdx.y * k.out_mult_y + blockIdx.x * k.step_output) * VEC;
  p.row = threadIdx.y * k.in_mult_y + blockIdx.y * k.in_mult_cta;
  p.live = p.ch < C && p.row < R;
  return p;
}

// A lane's per-channel constants, read once: the mean, the scale rstd *
// weight, the bias and a pass's own coefficient (gsq).
template <int VEC>
struct Lane {
  float mu[VEC], s[VEC], b[VEC], k[VEC];

  __device__ __forceinline__ void load(const float* mean, const float* rstd, const float* weight,
                                       const float* bias, const float* coef, int ch) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      mu[c] = mean == nullptr ? 0.f : mean[ch + c];
      s[c] = rstd == nullptr ? 0.f : __fmul_rn(rstd[ch + c], weight[ch + c]);
      b[c] = bias == nullptr ? 0.f : bias[ch + c];
      k[c] = coef == nullptr ? 0.f : coef[ch + c];
    }
  }

  __device__ __forceinline__ float centred(float x, int c) const { return __fsub_rn(x, mu[c]); }

  // The pre-activation output y.
  __device__ __forceinline__ float y(float x, int c) const {
    return __fadd_rn(__fmul_rn(centred(x, c), s[c]), b[c]);
  }

  // The gradient at y: dy through the activation's slope.
  template <bool ACT>
  __device__ __forceinline__ float gy(float dy, float x, int c) const {
    return ACT && !(y(x, c) > 0.f) ? __fmul_rn(dy, 0.2f) : dy;
  }

  // The gradient at c (k holding gsq): gy * s, then gsq * c added twice,
  // once for each factor of c * c, in autograd's order.
  template <bool ACT>
  __device__ __forceinline__ float gc(float dy, float x, int c) const {
    const float sq = __fmul_rn(k[c], centred(x, c));
    return __fadd_rn(__fadd_rn(__fmul_rn(gy<ACT>(dy, x, c), s[c]), sq), sq);
  }
};

// What a sum adds, a row at a time: x (the mean), c * c (the variance), gy
// and gy * c (the bias and weight gradients), or gc (the mean's gradient).
enum class Sum { kX, kSquares, kGrad, kGradC };

template <Sum S, bool ACT, int VEC>
__device__ __forceinline__ void quantities(const Lane<VEC>& l, const Row<VEC>& x,
                                           const Row<VEC>& dy, float (&q)[2][VEC]) {
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    if constexpr (S == Sum::kX) {
      q[0][c] = x.v[c];
    } else if constexpr (S == Sum::kSquares) {
      const float d = l.centred(x.v[c], c);
      q[0][c] = __fmul_rn(d, d);
    } else if constexpr (S == Sum::kGrad) {
      q[0][c] = l.template gy<ACT>(dy.v[c], x.v[c], c);
      q[1][c] = __fmul_rn(q[0][c], l.centred(x.v[c], c));
    } else {
      q[0][c] = l.template gc<ACT>(dy.v[c], x.v[c], c);
    }
  }
}

// A sum's first launch: each block's column partials into part [K, ctas, C],
// in ReduceOp::thread_reduce_impl's order and then block_y_reduce's.
template <Sum S, bool ACT, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
batch_norm_sum_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ weight, const float* __restrict__ bias,
                      const float* __restrict__ coef, float* __restrict__ part, int R, int C,
                      Config k) {
  constexpr int K = S == Sum::kGrad ? 2 : 1;
  constexpr bool kDy = S == Sum::kGrad || S == Sum::kGradC;
  __shared__ float sh[K][kMaxThreads];
  const Place p = place<VEC>(k, R, C);
  float acc[kVt][K][VEC];
#pragma unroll
  for (int i = 0; i < kVt; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[i][j][c] = 0.f;
  if (p.live) {
    Lane<VEC> l;
    l.load(mean, rstd, weight, bias, coef, p.ch);
    const size_t stride = static_cast<size_t>(k.step_input) * C;
    const float* px = x + static_cast<size_t>(p.row) * C + p.ch;
    const float* pdy = kDy ? dy + static_cast<size_t>(p.row) * C + p.ch : nullptr;
    int idx = p.row;
    Row<VEC> vx[kVt], vdy[kVt];
    while (idx + (kVt - 1) * k.step_input < R) {
#pragma unroll
      for (int i = 0; i < kVt; ++i) {
        vx[i].load(px + i * stride);
        if constexpr (kDy) vdy[i].load(pdy + i * stride);
      }
#pragma unroll
      for (int i = 0; i < kVt; ++i) {
        float q[2][VEC];
        quantities<S, ACT>(l, vx[i], vdy[i], q);
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[i][j][c] += q[j][c];
      }
      idx += kVt * k.step_input;
      px += kVt * stride;
      if constexpr (kDy) pdy += kVt * stride;
    }
#pragma unroll
    for (int i = 0; i < kVt; ++i) {
      if (idx + i * k.step_input < R) {
        vx[i].load(px + i * stride);
        if constexpr (kDy) vdy[i].load(pdy + i * stride);
        float q[2][VEC];
        quantities<S, ACT>(l, vx[i], vdy[i], q);
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[i][j][c] += q[j][c];
      }
    }
#pragma unroll
    for (int i = 1; i < kVt; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[0][j][c] += acc[i][j][c];
  }
  if (k.in_mult_y != 0) {  // the block's row groups add in a tree
    const int t = threadIdx.x + threadIdx.y * blockDim.x;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int c = 0; c < VEC; ++c) sh[j][t * VEC + c] = acc[0][j][c];
    for (int offset = blockDim.y / 2; offset > 0; offset >>= 1) {
      __syncthreads();
      if (threadIdx.y < offset && threadIdx.y + offset < blockDim.y) {
        const int u = t + offset * blockDim.x;
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            acc[0][j][c] += sh[j][u * VEC + c];
            sh[j][t * VEC + c] = acc[0][j][c];
          }
      }
    }
    if (threadIdx.y != 0) return;
  }
  if (p.ch < C) {
    const size_t plane = static_cast<size_t>(k.ctas) * C;
    const size_t o = static_cast<size_t>(blockIdx.y) * C + p.ch;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int c = 0; c < VEC; ++c) part[j * plane + o + c] = acc[0][j][c];
  }
}

// A sum's second launch, and what follows from it for each channel. Block
// (fx, bh): where ctas > 1, thread y adds the partials of blocks y, y + bh,
// ... from 0 and the bh row groups add in a tree (ReduceOp::global_reduce);
// with one block a column its partial is the sum.
template <Sum S>
__global__ void __launch_bounds__(1024)
batch_norm_finish_kernel(const float* __restrict__ part, int R, int C, int ctas, float factor,
                         float eps, float keep, float take, const float* __restrict__ weight,
                         float* __restrict__ mean, float* __restrict__ rstd,
                         float* __restrict__ running_mean, float* __restrict__ running_var,
                         float* __restrict__ dweight, float* __restrict__ dbias,
                         float* __restrict__ coef) {
  constexpr int K = S == Sum::kGrad ? 2 : 1;
  extern __shared__ float sh[];  // [K][bh][fx]
  const int fx = blockDim.x, bh = blockDim.y, y = threadIdx.y;
  const int ch = blockIdx.x * fx + threadIdx.x;
  const size_t plane = static_cast<size_t>(ctas) * C;
  float v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) v[j] = 0.f;
  if (ch < C) {
    if (ctas == 1) {
#pragma unroll
      for (int j = 0; j < K; ++j) v[j] = part[j * plane + ch];
    } else {
      for (int o = y; o < ctas; o += bh)
#pragma unroll
        for (int j = 0; j < K; ++j) v[j] += part[j * plane + static_cast<size_t>(o) * C + ch];
    }
  }
  if (ctas > 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) sh[(j * bh + y) * fx + threadIdx.x] = v[j];
    for (int offset = bh / 2; offset > 0; offset >>= 1) {
      __syncthreads();
      if (y < offset && y + offset < bh) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          v[j] += sh[(j * bh + y + offset) * fx + threadIdx.x];
          sh[(j * bh + y) * fx + threadIdx.x] = v[j];
        }
      }
    }
  }
  if (y != 0 || ch >= C) return;
  const float inv_r = 1.0f / static_cast<float>(R);  // autograd's division by R
  if constexpr (S == Sum::kX) {
    mean[ch] = __fmul_rn(v[0], factor);
  } else if constexpr (S == Sum::kSquares) {
    const float var = __fmul_rn(v[0], factor);
    rstd[ch] = rsqrtf(__fadd_rn(var, eps));
    running_mean[ch] = __fadd_rn(__fmul_rn(keep, running_mean[ch]), __fmul_rn(take, mean[ch]));
    running_var[ch] = __fadd_rn(__fmul_rn(keep, running_var[ch]), __fmul_rn(take, var));
  } else if constexpr (S == Sum::kGrad) {
    const float r = rstd[ch];
    dbias[ch] = v[0];
    dweight[ch] = __fmul_rn(v[1], r);
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    const float g_var = __fmul_rn(__fmul_rn(__fmul_rn(v[1], weight[ch]), -0.5f), r3);
    coef[ch] = __fmul_rn(g_var, inv_r);  // gsq
  } else {
    coef[ch] = -__fmul_rn(v[0], inv_r);  // the mean's gradient, a row's share
  }
}

// The forward's output: y, through the activation where ACT.
template <bool ACT, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
batch_norm_apply_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                        const float* __restrict__ rstd, const float* __restrict__ weight,
                        const float* __restrict__ bias, float* __restrict__ y, int R, int C,
                        Config k) {
  const Place p = place<VEC>(k, R, C);
  if (!p.live) return;
  Lane<VEC> l;
  l.load(mean, rstd, weight, bias, nullptr, p.ch);
  for (int r0 = p.row; r0 < R; r0 += kVt * k.step_input) {
    Row<VEC> v[kVt];
#pragma unroll
    for (int i = 0; i < kVt; ++i) {
      const int r = r0 + i * k.step_input;
      if (r < R) v[i].load(x + static_cast<size_t>(r) * C + p.ch);
    }
#pragma unroll
    for (int i = 0; i < kVt; ++i) {
      const int r = r0 + i * k.step_input;
      if (r < R) {
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float z = l.y(v[i].v[c], c);
          v[i].v[c] = ACT && !(z > 0.f) ? __fmul_rn(z, 0.2f) : z;
        }
        v[i].store(y + static_cast<size_t>(r) * C + p.ch);
      }
    }
  }
}

// The backward's output: dx = gc + gmean (the mean's gradient, a row's share).
template <bool ACT, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
batch_norm_grad_input_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                             const float* __restrict__ mean, const float* __restrict__ rstd,
                             const float* __restrict__ weight, const float* __restrict__ bias,
                             const float* __restrict__ gsq, const float* __restrict__ gmean,
                             float* __restrict__ dx, int R, int C, Config k) {
  const Place p = place<VEC>(k, R, C);
  if (!p.live) return;
  Lane<VEC> l;
  l.load(mean, rstd, weight, bias, gsq, p.ch);
  float gm[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) gm[c] = gmean[p.ch + c];
  for (int r0 = p.row; r0 < R; r0 += kVt * k.step_input) {
    Row<VEC> g[kVt], v[kVt];
#pragma unroll
    for (int i = 0; i < kVt; ++i) {
      const int r = r0 + i * k.step_input;
      if (r < R) {
        g[i].load(dy + static_cast<size_t>(r) * C + p.ch);
        v[i].load(x + static_cast<size_t>(r) * C + p.ch);
      }
    }
#pragma unroll
    for (int i = 0; i < kVt; ++i) {
      const int r = r0 + i * k.step_input;
      if (r < R) {
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          g[i].v[c] = __fadd_rn(l.template gc<ACT>(g[i].v[c], v[i].v[c], c), gm[c]);
        g[i].store(dx + static_cast<size_t>(r) * C + p.ch);
      }
    }
  }
}

// The launch shapes, checked: false on one the kernels do not take.
struct Launch {
  dim3 grid, block, fin_grid, fin_block;
  size_t fin_smem;
  Config k;
};

bool make_launch(int R, int C, int vec, int bw, int bh, int ctas, int out_mult_y, int in_mult_y,
                 int step_output, int step_input, Launch& f) {
  const bool pow2 = bh > 0 && (bh & (bh - 1)) == 0;
  if (R < 1 || C < 1 || !(vec == 1 || vec == 2 || vec == 4) || C % vec != 0 || bw < 1 ||
      !pow2 || bw * bh > kMaxThreads / vec || ctas < 1 || ctas > 65535 || step_output < 1 ||
      step_input < 1 || !(in_mult_y == 0 || in_mult_y == 1) ||
      (ctas > 1 && (in_mult_y != 1 || step_input != bh * ctas)))
    return false;
  f.k = Config{out_mult_y, step_output, in_mult_y, ctas > 1 ? bh : 0, step_input, ctas};
  f.grid = dim3(mpa::ceil_div(C / vec, step_output), ctas);
  f.block = dim3(bw, bh);
  const int fx = min(32, 1024 / bh);
  f.fin_grid = dim3(mpa::ceil_div(C, fx));
  f.fin_block = dim3(fx, bh);
  f.fin_smem = 2 * sizeof(float) * fx * bh;
  return true;
}

bool aligned(std::initializer_list<const void*> ptrs, int vec) {
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % (sizeof(float) * vec) != 0) return false;
  return true;
}

template <Sum S, bool ACT>
cudaError_t sum(const Launch& f, int vec, const float* x, const float* dy, const float* mean,
                const float* rstd, const float* weight, const float* bias, const float* coef,
                float* part, int R, int C, cudaStream_t st) {
  auto kernel = vec == 4   ? batch_norm_sum_kernel<S, ACT, 4>
                : vec == 2 ? batch_norm_sum_kernel<S, ACT, 2>
                           : batch_norm_sum_kernel<S, ACT, 1>;
  kernel<<<f.grid, f.block, 0, st>>>(x, dy, mean, rstd, weight, bias, coef, part, R, C, f.k);
  return cudaGetLastError();
}

template <Sum S>
cudaError_t finish(const Launch& f, const float* part, int R, int C, float factor, float eps,
                   float keep, float take, const float* weight, float* mean, float* rstd,
                   float* running_mean, float* running_var, float* dweight, float* dbias,
                   float* coef, cudaStream_t st) {
  batch_norm_finish_kernel<S><<<f.fin_grid, f.fin_block, f.fin_smem, st>>>(
      part, R, C, f.k.ctas, factor, eps, keep, take, weight, mean, rstd, running_mean,
      running_var, dweight, dbias, coef);
  return cudaGetLastError();
}

template <bool ACT>
cudaError_t forward(const Launch& f, int vec, const float* x, const float* weight,
                    const float* bias, float* running_mean, float* running_var, float* y,
                    float* mean, float* rstd, float* part, int R, int C, float factor, float eps,
                    float keep, float take, cudaStream_t st) {
  cudaError_t err = sum<Sum::kX, ACT>(f, vec, x, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, part, R, C, st);
  if (err == cudaSuccess)
    err = finish<Sum::kX>(f, part, R, C, factor, eps, keep, take, weight, mean, rstd,
                          running_mean, running_var, nullptr, nullptr, nullptr, st);
  if (err == cudaSuccess)
    err = sum<Sum::kSquares, ACT>(f, vec, x, nullptr, mean, nullptr, nullptr, nullptr, nullptr,
                                  part, R, C, st);
  if (err == cudaSuccess)
    err = finish<Sum::kSquares>(f, part, R, C, factor, eps, keep, take, weight, mean, rstd,
                                running_mean, running_var, nullptr, nullptr, nullptr, st);
  if (err != cudaSuccess) return err;
  auto apply = vec == 4   ? batch_norm_apply_kernel<ACT, 4>
               : vec == 2 ? batch_norm_apply_kernel<ACT, 2>
                          : batch_norm_apply_kernel<ACT, 1>;
  apply<<<f.grid, f.block, 0, st>>>(x, mean, rstd, weight, bias, y, R, C, f.k);
  return cudaGetLastError();
}

template <bool ACT>
cudaError_t backward(const Launch& f, int vec, const float* dy, const float* x,
                     const float* weight, const float* bias, const float* mean,
                     const float* rstd, float* dx, float* dweight, float* dbias, float* part,
                     float* gsq, float* gmean, int R, int C, cudaStream_t st) {
  cudaError_t err = sum<Sum::kGrad, ACT>(f, vec, x, dy, mean, rstd, weight, bias, nullptr, part,
                                         R, C, st);
  if (err == cudaSuccess)
    err = finish<Sum::kGrad>(f, part, R, C, 0.f, 0.f, 0.f, 0.f, weight, nullptr,
                             const_cast<float*>(rstd), nullptr, nullptr, dweight, dbias, gsq,
                             st);
  if (err == cudaSuccess)
    err = sum<Sum::kGradC, ACT>(f, vec, x, dy, mean, rstd, weight, bias, gsq, part, R, C, st);
  if (err == cudaSuccess)
    err = finish<Sum::kGradC>(f, part, R, C, 0.f, 0.f, 0.f, 0.f, weight, nullptr, nullptr,
                              nullptr, nullptr, nullptr, nullptr, gmean, st);
  if (err != cudaSuccess) return err;
  auto input = vec == 4   ? batch_norm_grad_input_kernel<ACT, 4>
               : vec == 2 ? batch_norm_grad_input_kernel<ACT, 2>
                          : batch_norm_grad_input_kernel<ACT, 1>;
  input<<<f.grid, f.block, 0, st>>>(dy, x, mean, rstd, weight, bias, gsq, gmean, dx, R, C, f.k);
  return cudaGetLastError();
}

}  // namespace

// Both entries take the reduction's shape (vec, bw, bh, ctas, out_mult_y,
// in_mult_y, step_output, step_input) as ops/batch_norm.py::reduce_config
// gives it; any other, or rows not aligned to vec floats, is refused with
// cudaErrorInvalidValue.
//
// Forward. x [R,C] f32 contiguous; weight, bias, running_mean, running_var
// [C] f32; out: y [R,C], mean [C], rstd [C]; part: f32 scratch of ctas * C
// floats. running_mean and running_var are updated in place (keep * running +
// take * batch). factor: the mean's C / (R * C), taken in float as PyTorch
// takes it.
MPA_EXPORT int mpa_batch_norm_act(const void* x, const void* weight, const void* bias,
                                  void* running_mean, void* running_var, void* y, void* mean,
                                  void* rstd, void* part, int R, int C, int vec, int bw, int bh,
                                  int ctas, int out_mult_y, int in_mult_y, int step_output,
                                  int step_input, float factor, float eps, float keep,
                                  float take, int act, void* stream) {
  Launch f;
  if (!make_launch(R, C, vec, bw, bh, ctas, out_mult_y, in_mult_y, step_output, step_input, f) ||
      !aligned({x, y}, vec))
    return cudaErrorInvalidValue;
  auto run = act ? forward<true> : forward<false>;
  return run(f, vec, static_cast<const float*>(x), static_cast<const float*>(weight),
             static_cast<const float*>(bias), static_cast<float*>(running_mean),
             static_cast<float*>(running_var), static_cast<float*>(y), static_cast<float*>(mean),
             static_cast<float*>(rstd), static_cast<float*>(part), R, C, factor, eps, keep, take,
             mpa::as_stream(stream));
}

// Backward. dy, x [R,C] f32 contiguous; weight, bias, mean, rstd [C] (mean and
// rstd as the forward gave them); out: dx [R,C], dweight [C], dbias [C];
// part: f32 scratch of (2 * ctas + 2) * C floats. The shape as the forward's
// (dy, x and dx aligned to vec floats).
MPA_EXPORT int mpa_batch_norm_act_bwd(const void* dy, const void* x, const void* weight,
                                      const void* bias, const void* mean, const void* rstd,
                                      void* dx, void* dweight, void* dbias, void* part, int R,
                                      int C, int vec, int bw, int bh, int ctas, int out_mult_y,
                                      int in_mult_y, int step_output, int step_input, int act,
                                      void* stream) {
  Launch f;
  if (!make_launch(R, C, vec, bw, bh, ctas, out_mult_y, in_mult_y, step_output, step_input, f) ||
      !aligned({dy, x, dx}, vec))
    return cudaErrorInvalidValue;
  float* pf = static_cast<float*>(part);
  float* gsq = pf + 2 * static_cast<size_t>(ctas) * C;
  auto run = act ? backward<true> : backward<false>;
  return run(f, vec, static_cast<const float*>(dy), static_cast<const float*>(x),
             static_cast<const float*>(weight), static_cast<const float*>(bias),
             static_cast<const float*>(mean), static_cast<const float*>(rstd),
             static_cast<float*>(dx), static_cast<float*>(dweight), static_cast<float*>(dbias),
             pf, gsq, gsq + C, R, C, mpa::as_stream(stream));
}
