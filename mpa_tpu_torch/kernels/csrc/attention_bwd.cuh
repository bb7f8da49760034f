// The one-pass body of the attention backward kernels
// (transition_attention_bwd_kernel in attention_bwd.cu, whose header spells
// out the contract, and windowed_attention_bwd_kernel in
// window_attention_bwd.cu): one thread per (query, channel), templated on K
// (8, 16, 32, 64). It loads its K (E, V) pairs once into registers, computes
// attn, the maximum and its tie set (a K-bit mask) once, in the forward
// kernel's operations and order, then t, corr and the tie terms, and adds
// each neighbour's dE (and a tie's dV) into the zeroed f32 dpacked with
// atomicAdd. Several queries share a block (at most 128 threads across the
// channels); each block stages its queries' indices in shared memory.
// Storage T: float, or bf16 for packed, shifts, gctx and dshift alike (the
// mixed precision models'): each value is widened to f32 as it is read, the
// arithmetic and the atomic adds into dpacked stay f32, dshift is rounded to
// bf16 once as it is stored, and a second pass rounds the f32 dpacked into
// the bf16 one (attention_pallas.py:665,675 casts its f32 dpacked and
// dshift to the storage type).
#pragma once

#include "common.cuh"

namespace mpa {

constexpr float kAttentionEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int KMAX, typename T>
__device__ __forceinline__ void attention_bwd_body(
    const T* __restrict__ packed, const int* __restrict__ idx,
    const T* __restrict__ shifts, const T* __restrict__ gctx,
    float* __restrict__ dpacked, T* __restrict__ dshift,
    int N, int S, int K, int n_branches, int C) {
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

  const T* pb = packed + static_cast<size_t>(b) * N * W;
  float* db = dpacked + static_cast<size_t>(b) * N * W;
  const size_t orow = (static_cast<size_t>(b) * S + s) * Wo;
  for (int oc = tx; oc < Wo; oc += blockDim.x) {
    const int r = oc / C;
    const int e_off = 2 * r * C + (oc - r * C);
    const int v_off = e_off + C;
    const float shift = shifts != nullptr ? load1(shifts + orow + oc) : 0.f;
    float e[KMAX], v[KMAX];
    float denom = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const T* row = pb + static_cast<size_t>(my_idx[k]) * W;
        e[k] = load1(row + e_off);
        v[k] = load1(row + v_off);
        if (shifts != nullptr) v[k] = __fadd_rn(v[k], shift);
        denom = k == 0 ? e[k] : __fadd_rn(denom, e[k]);  // the forward's order
      }
    }
    const float den = fmaxf(denom, kAttentionEps);

    // The maximum of w over K and the set of neighbours that reach it.
    float m = -INFINITY;
    unsigned long long ties = 0ull;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float w = __fmul_rn(__fsub_rn(__fdiv_rn(e[k], den), 1.f), v[k]);
        if (w > m) {
          m = w;
          ties = 1ull << k;
        } else if (w == m) {
          ties |= 1ull << k;
        }
      }
    }
    const float cnt = static_cast<float>(__popcll(ties));
    const float dw = __fmul_rn(__fdiv_rn(1.f, cnt), load1(gctx + orow + oc));

    // t = sum_k dattn_k * E_k and dshift = sum_k dV_k; both vanish off the ties.
    float t = 0.f, ds = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K && ((ties >> k) & 1ull)) {
        const float attn = __fsub_rn(__fdiv_rn(e[k], den), 1.f);
        t = __fadd_rn(t, __fmul_rn(__fmul_rn(dw, v[k]), e[k]));
        ds = __fadd_rn(ds, __fmul_rn(dw, attn));
      }
    }
    const float corr = denom >= kAttentionEps ? __fdiv_rn(t, __fmul_rn(den, den)) : 0.f;

#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const size_t n = static_cast<size_t>(my_idx[k]) * W;
        if ((ties >> k) & 1ull) {
          const float attn = __fsub_rn(__fdiv_rn(e[k], den), 1.f);
          atomicAdd(db + n + e_off, __fsub_rn(__fdiv_rn(__fmul_rn(dw, v[k]), den), corr));
          atomicAdd(db + n + v_off, __fmul_rn(dw, attn));
        } else {
          atomicAdd(db + n + e_off, -corr);  // dattn_k = 0: dE_k = 0 / den - corr
        }
      }
    }
    if (dshift != nullptr) store1(dshift + orow + oc, ds);
  }
}

template <typename T>
using AttentionBwdKernel = void (*)(const T*, const int*, const T*, const T*, float*, T*, int, int,
                                    int, int, int);

// dpacked16[i] = bf16(dpacked[i]) for i < n, four a thread where the
// pointers allow (n is even: 2 * n_branches * C values a row).
static __global__ void __launch_bounds__(256)
round_to_bf16_kernel(const float* __restrict__ src, bf16* __restrict__ dst, size_t n) {
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    const float x[4] = {v.x, v.y, v.z, v.w};
    store_bf16<4>(dst + i, x);
  } else {
    for (size_t j = i; j < n; ++j) dst[j] = __float2bfloat16_rn(src[j]);
  }
}

// Zero dpacked on the stream, then launch kernels[i] for the least KMAX of
// 8, 16, 32, 64 (i = 0..3) that holds K: threads across the output
// channels, at most 128, so that a block holds two or more queries, the
// rest of 256 across queries; shared memory for the block's indices. For
// bf16 storage, dpacked is the f32 accumulator and a second kernel rounds
// it into dpacked16 (8-byte aligned).
template <typename T>
inline cudaError_t launch_attention_bwd(const AttentionBwdKernel<T> (&kernels)[4],
                                        const void* packed, const void* idx, const void* shifts,
                                        const void* gctx, void* dpacked, void* dpacked16,
                                        void* dshift, int B, int N, int S, int K, int n_branches,
                                        int C, cudaStream_t st) {
  const int Wo = n_branches * C;
  const size_t n = static_cast<size_t>(B) * N * 2 * Wo;
  cudaError_t err = cudaMemsetAsync(dpacked, 0, sizeof(float) * n, st);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || Wo == 0) {
    err = cudaGetLastError();
  } else {
    int tx = ceil_div(Wo, 32) * 32;
    if (tx > 128) tx = 128;
    const dim3 block(tx, 256 / tx);
    const size_t smem = sizeof(int) * static_cast<size_t>(block.y) * K;
    const AttentionBwdKernel<T> kernel = kernels[K <= 8 ? 0 : K <= 16 ? 1 : K <= 32 ? 2 : 3];
    kernel<<<dim3(ceil_div(S, block.y), B), block, smem, st>>>(
        static_cast<const T*>(packed), static_cast<const int*>(idx),
        static_cast<const T*>(shifts), static_cast<const T*>(gctx),
        static_cast<float*>(dpacked), static_cast<T*>(dshift), N, S, K, n_branches, C);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || std::is_same<T, float>::value || n == 0) return err;
  if (reinterpret_cast<uintptr_t>(dpacked16) % 8 != 0) return cudaErrorInvalidValue;
  const size_t blocks = (n + 4 * 256 - 1) / (4 * 256);
  round_to_bf16_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(dpacked), static_cast<bf16*>(dpacked16), n);
  return cudaGetLastError();
}

}  // namespace mpa
