// The one-pass body of the attention forward kernels
// (transition_attention_fwd_kernel in attention.cu, whose header spells out
// the contract, and windowed_attention_fwd_kernel in window_attention.cu).
//
// One block per (batch, tile of consecutive queries); the block stages its
// queries' K indices in shared memory once; threads run across the output
// channels, so each gathered row is read by neighbouring threads at
// neighbouring addresses (coalesced). Templated on KMAX (8, 16, 32, 64; a
// runtime K <= KMAX is masked) and VEC: a thread issues all its K (E, V)
// loads up front into registers, then takes the denominator and the maximum
// from registers, so each (E, V) pair is read once. VEC = 4: a thread owns
// four channels, float4 loads of E, V and the shift and a float4 store (C %
// 4 == 0, 16-byte aligned packed, shifts and out, K <= 16:
// ops/attention.py::attention_fwd_form picks it, and launch_attention_fwd
// refuses it otherwise); VEC = 1 for every other shape. The denominator
// starts from E_0 and adds in neighbour order, every operation separately
// rounded (no FMA), the maximum starts from -inf: the plain version's order
// (ops/attention.py::attention_plain), so the two agree bit for bit.
#pragma once

#include "common.cuh"

namespace mpa {

constexpr int kAttentionFwdThreads = 256;

template <int VEC>
__device__ __forceinline__ void attention_load(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void attention_store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// Three blocks an SM where the rows fit 85 registers (K <= 8 at four
// channels, K <= 32 at one): the loads of one block then overlap the
// arithmetic of another (measured 18% faster than two blocks an SM, PERF.md
// section 6; four spill). Each kernel that runs the body declares
// __launch_bounds__(kAttentionFwdThreads, attention_fwd_min_blocks(KMAX, VEC)).
constexpr int attention_fwd_min_blocks(int kmax, int vec) { return kmax * vec <= 32 ? 3 : 1; }

template <int KMAX, int VEC>
__device__ __forceinline__ void attention_fwd_body(
    const float* __restrict__ packed, const int* __restrict__ idx,
    const float* __restrict__ shifts, float* __restrict__ out,
    int N, int S, int K, int n_branches, int C) {
  constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor
  extern __shared__ int idx_s[];  // [blockDim.y][K]
  const int b = blockIdx.y;
  const int ty = threadIdx.y, tx = threadIdx.x;
  const int s = blockIdx.x * blockDim.y + ty;
  const int W = 2 * n_branches * C;
  const int Wo = n_branches * C;
  int* my_idx = idx_s + ty * K;
  if (s < S) {
    for (int k = tx; k < K; k += blockDim.x)
      my_idx[k] = idx[(static_cast<size_t>(b) * S + s) * K + k];
  }
  __syncthreads();
  if (s >= S) return;

  const float* pb = packed + static_cast<size_t>(b) * N * W;
  const size_t orow = (static_cast<size_t>(b) * S + s) * Wo;
  for (int oc = tx * VEC; oc < Wo; oc += blockDim.x * VEC) {
    const int r = oc / C;
    const int e_off = 2 * r * C + (oc - r * C);
    const int v_off = e_off + C;
    float e[KMAX][VEC], v[KMAX][VEC];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float* row = pb + static_cast<size_t>(my_idx[k]) * W;
        attention_load(row + e_off, e[k]);
        attention_load(row + v_off, v[k]);
      }
    }
    float shift[VEC];
    if (shifts != nullptr) attention_load(shifts + orow + oc, shift);
    float m[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float denom = e[0][i];
#pragma unroll
      for (int k = 1; k < KMAX; ++k) {
        if (k < K) denom = __fadd_rn(denom, e[k][i]);
      }
      const float den = fmaxf(denom, kEps);
      m[i] = -INFINITY;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const float vk = shifts != nullptr ? __fadd_rn(v[k][i], shift[i]) : v[k][i];
          const float attn = __fsub_rn(__fdiv_rn(e[k][i], den), 1.f);
          m[i] = fmaxf(m[i], __fmul_rn(attn, vk));
        }
      }
    }
    attention_store(out + orow + oc, m);
  }
}

using AttentionFwdKernel = void (*)(const float*, const int*, const float*, float*, int, int, int,
                                    int, int);

// One kernel's instantiations: four channels a thread at KMAX 8 and 16,
// one at KMAX 8, 16, 32 and 64.
struct AttentionFwdKernels {
  AttentionFwdKernel vec4[2];
  AttentionFwdKernel vec1[4];
};

// Launch the least KMAX that holds K, at vec channels a thread: threads
// across the output slots (a power of two, at most 128), the rest of 256
// across consecutive queries; shared memory for the block's indices.
// vec = 4 needs C % 4 == 0, K <= 16 and 16-byte aligned packed, shifts and
// out, else cudaErrorInvalidValue; vec = 1 takes any shape.
inline cudaError_t launch_attention_fwd(const AttentionFwdKernels& kernels, const void* packed,
                                        const void* idx, const void* shifts, void* out, int B,
                                        int N, int S, int K, int n_branches, int C, int vec,
                                        cudaStream_t st) {
  if (B == 0 || S == 0 || n_branches * C == 0) return cudaGetLastError();
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  AttentionFwdKernel kernel;
  if (vec == 1) {
    kernel = kernels.vec1[K <= 8 ? 0 : K <= 16 ? 1 : K <= 32 ? 2 : 3];
  } else if (vec == 4 && C % 4 == 0 && K <= 16 && !misaligned(packed) && !misaligned(out) &&
             (shifts == nullptr || !misaligned(shifts))) {
    kernel = kernels.vec4[K <= 8 ? 0 : 1];
  } else {
    return cudaErrorInvalidValue;
  }
  const int slots = n_branches * C / vec;
  int tx = 1;
  while (tx < slots && tx < 128) tx *= 2;
  const dim3 block(tx, kAttentionFwdThreads / tx);
  const dim3 grid(ceil_div(S, block.y), B);
  const size_t smem = sizeof(int) * static_cast<size_t>(block.y) * K;
  kernel<<<grid, block, smem, st>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const float*>(shifts), static_cast<float*>(out), N, S, K, n_branches, C);
  return cudaGetLastError();
}

}  // namespace mpa

