// transition_attention_bwd_kernel: transition attention backward, fused with
// the scatter of the edge gradients into the node gradients.
//
// Replaces two TPU kernels that compute one function, the VJP of
// mpa_tpu/ops/pallas/attention_pallas.py::transition_attention:
// ::_fused_small_bwd (kernel body _fused_small_bwd_kernel, N <= 512, gather
// and scatter done in-kernel as one-hot matmuls) and ::_bwd_scatter_pallas
// (kernel body _bwd_scatter_kernel, 512 < N <= 4096, over a pre-gathered
// edge tensor); it also computes what _bwd_scatter_xla does above N = 4096.
// Contract (attention_pallas.py _attn_math, g != None): packed [B,N,nB*2C]
// f32 holding [E_r || V_r] per branch r, idx [B,S,K] int32 in [0, N),
// shifts [B,S,nB*C] f32 or null, gctx [B,S,nB*C] f32 ->
// dpacked [B,N,nB*2C] f32 and, with shifts, dshift [B,S,nB*C] f32. Per
// branch, query and channel, with V' = V + shift:
//   denom = sum_k E,  den = max(denom, 1e-20),  attn = E / den - 1,
//   w = attn * V',  m = max_k w,  ties = {k : w_k == m},  cnt = |ties|,
//   dw_k  = [k in ties] * (1 / cnt) * g     (max gradient split among ties),
//   dV_k  = dw_k * attn_k,   dattn_k = dw_k * V'_k,
//   t     = sum_k dattn_k * E_k,
//   corr  = denom >= 1e-20 ? t / (den * den) : 0,
//   dE_k  = dattn_k / den - corr,
//   dpacked[idx_k] += [dE_k || dV_k],   dshift = sum_k dV_k.
//
// What bounds it on the H100: bytes, by count. Each (query, neighbour) reads
// one packed row and adds one row of gradients; the arithmetic is a few
// operations per gathered float.
//
// Design: one pass over the gathered rows. One thread per (query, channel),
// templated on K (8, 16, 32, 64): it loads its K (E, V) pairs once into
// registers and computes attn, the maximum and its tie set (a K-bit mask)
// once, in the forward kernel's operations and order, then t, corr and the
// tie terms, and adds each neighbour's dE (and a tie's dV) into the zeroed
// f32 dpacked with atomicAdd. Several queries share a block (at most 128
// threads across the channels). Adds from different queries land in no
// fixed order, so dpacked can differ from a sequential sum in the last bits.
// The design before this one read the rows three times (the denominator,
// the maximum, the outputs). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (profile_port.py --kernels against copies with one part cut, the sum
// over a train step's launches; PERF.md has the readings): that design's
// atomics cost 2-3% of its time and its re-reads about a third; a reverse
// index of idx that replaced the node atomics by a gather per node was
// slower than both. This one takes about three quarters of that design's
// time on markov_partseg and markov_cls; of it the atomics are a sixth and
// the zeroing a sixteenth, the one pass over the gathered rows the rest.
// The TPU's one-hot matmul scatter and its bf16 gradient rounding
// (GRAD_SCATTER_PRECISION) are not carried over: every add is f32.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor

template <int KMAX>
__global__ void transition_attention_bwd_kernel(
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
    const float den = fmaxf(denom, kEps);

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
    const float corr = denom >= kEps ? __fdiv_rn(t, __fmul_rn(den, den)) : 0.f;

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

template <int KMAX>
cudaError_t launch(const float* packed, const int* idx, const float* shifts, const float* gctx,
                   float* dpacked, float* dshift, int B, int N, int S, int K, int nB, int C,
                   cudaStream_t st) {
  // Threads across the output channels, at most 128, so that a block holds
  // two or more queries; the rest of 256 across queries.
  int tx = mpa::ceil_div(nB * C, 32) * 32;
  if (tx > 128) tx = 128;
  const dim3 block(tx, 256 / tx);
  const size_t smem = sizeof(int) * static_cast<size_t>(block.y) * K;
  transition_attention_bwd_kernel<KMAX><<<dim3(mpa::ceil_div(S, block.y), B), block, smem, st>>>(
      packed, idx, shifts, gctx, dpacked, dshift, N, S, K, nB, C);
  return cudaGetLastError();
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32, shifts [B,S,nB*C] or null,
// gctx [B,S,nB*C], dpacked [B,N,nB*2C], dshift [B,S,nB*C] (null exactly when
// shifts is null); all contiguous f32 except idx. dpacked is zeroed here, on
// the same stream, before the adds. Requires 1 <= K <= 64 (checked by the
// Python wrapper).
MPA_EXPORT int mpa_transition_attention_bwd(const void* packed, const void* idx,
                                            const void* shifts, const void* gctx,
                                            void* dpacked, void* dshift, int B, int N, int S,
                                            int K, int n_branches, int C, void* stream) {
  cudaStream_t st = mpa::as_stream(stream);
  const int Wo = n_branches * C;
  cudaError_t err = cudaMemsetAsync(
      dpacked, 0, sizeof(float) * static_cast<size_t>(B) * N * 2 * Wo, st);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || Wo == 0) return cudaGetLastError();
  auto pk = static_cast<const float*>(packed);
  auto ip = static_cast<const int*>(idx);
  auto sh = static_cast<const float*>(shifts);
  auto g = static_cast<const float*>(gctx);
  auto dp = static_cast<float*>(dpacked);
  auto ds = static_cast<float*>(dshift);
  if (K <= 8) return launch<8>(pk, ip, sh, g, dp, ds, B, N, S, K, n_branches, C, st);
  if (K <= 16) return launch<16>(pk, ip, sh, g, dp, ds, B, N, S, K, n_branches, C, st);
  if (K <= 32) return launch<32>(pk, ip, sh, g, dp, ds, B, N, S, K, n_branches, C, st);
  return launch<64>(pk, ip, sh, g, dp, ds, B, N, S, K, n_branches, C, st);
}
