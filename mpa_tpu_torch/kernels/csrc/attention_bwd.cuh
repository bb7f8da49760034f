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
#pragma once

#include "common.cuh"

namespace mpa {

constexpr float kAttentionEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor

template <int KMAX>
__device__ __forceinline__ void attention_bwd_body(
    const float* __restrict__ packed, const int* __restrict__ idx,
    const float* __restrict__ shifts, const float* __restrict__ gctx,
    float* __restrict__ dpacked, float* __restrict__ dshift,
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

  const float* pb = packed + static_cast<size_t>(b) * N * W;
  float* db = dpacked + static_cast<size_t>(b) * N * W;
  const size_t orow = (static_cast<size_t>(b) * S + s) * Wo;
  for (int oc = tx; oc < Wo; oc += blockDim.x) {
    const int r = oc / C;
    const int e_off = 2 * r * C + (oc - r * C);
    const int v_off = e_off + C;
    const float shift = shifts != nullptr ? shifts[orow + oc] : 0.f;
    float e[KMAX], v[KMAX];
    float denom = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float* row = pb + static_cast<size_t>(my_idx[k]) * W;
        e[k] = row[e_off];
        v[k] = row[v_off];
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
    const float dw = __fmul_rn(__fdiv_rn(1.f, cnt), gctx[orow + oc]);

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
    if (dshift != nullptr) dshift[orow + oc] = ds;
  }
}

using AttentionBwdKernel = void (*)(const float*, const int*, const float*, const float*, float*,
                                   float*, int, int, int, int, int);

// Zero dpacked on the stream, then launch kernels[i] for the least KMAX of
// 8, 16, 32, 64 (i = 0..3) that holds K: threads across the output
// channels, at most 128, so that a block holds two or more queries, the
// rest of 256 across queries; shared memory for the block's indices.
inline cudaError_t launch_attention_bwd(const AttentionBwdKernel (&kernels)[4], const void* packed,
                                        const void* idx, const void* shifts, const void* gctx,
                                        void* dpacked, void* dshift, int B, int N, int S, int K,
                                        int n_branches, int C, cudaStream_t st) {
  const int Wo = n_branches * C;
  cudaError_t err = cudaMemsetAsync(
      dpacked, 0, sizeof(float) * static_cast<size_t>(B) * N * 2 * Wo, st);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || Wo == 0) return cudaGetLastError();
  int tx = ceil_div(Wo, 32) * 32;
  if (tx > 128) tx = 128;
  const dim3 block(tx, 256 / tx);
  const size_t smem = sizeof(int) * static_cast<size_t>(block.y) * K;
  const AttentionBwdKernel kernel = kernels[K <= 8 ? 0 : K <= 16 ? 1 : K <= 32 ? 2 : 3];
  kernel<<<dim3(ceil_div(S, block.y), B), block, smem, st>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const float*>(shifts), static_cast<const float*>(gctx),
      static_cast<float*>(dpacked), static_cast<float*>(dshift), N, S, K, n_branches, C);
  return cudaGetLastError();
}

}  // namespace mpa
