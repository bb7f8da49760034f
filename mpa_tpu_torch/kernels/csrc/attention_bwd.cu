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
// dpacked [B,N,nB*2C] f32 and, with shifts, dshift [B,S,nB*C] f32 (or
// packed, shifts and gctx bf16 -> dpacked and dshift bf16, the arithmetic
// and the adds f32, each output rounded once). Per
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
// (GRAD_SCATTER_PRECISION) are not carried over: every add is f32, in bf16
// storage too, and the f32 dpacked is rounded to bf16 by a second pass.
#include "attention_bwd.cuh"
#include "common.cuh"

namespace {

template <int KMAX, typename T>
__global__ void transition_attention_bwd_kernel(
    const T* __restrict__ packed, const int* __restrict__ idx,
    const T* __restrict__ shifts, const T* __restrict__ gctx,
    float* __restrict__ dpacked, T* __restrict__ dshift,
    int N, int S, int K, int n_branches, int C) {
  mpa::attention_bwd_body<KMAX>(packed, idx, shifts, gctx, dpacked, dshift, N, S, K, n_branches,
                                C);
}

template <typename T>
cudaError_t launch(const void* packed, const void* idx, const void* shifts, const void* gctx,
                   void* dpacked, void* dpacked16, void* dshift, int B, int N, int S, int K,
                   int n_branches, int C, cudaStream_t st) {
  static const mpa::AttentionBwdKernel<T> kernels[4] = {
      transition_attention_bwd_kernel<8, T>, transition_attention_bwd_kernel<16, T>,
      transition_attention_bwd_kernel<32, T>, transition_attention_bwd_kernel<64, T>};
  return mpa::launch_attention_bwd(kernels, packed, idx, shifts, gctx, dpacked, dpacked16, dshift,
                                   B, N, S, K, n_branches, C, st);
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32, shifts [B,S,nB*C] or null,
// gctx [B,S,nB*C], dpacked [B,N,nB*2C] f32, dshift [B,S,nB*C] (null exactly
// when shifts is null); all contiguous; packed, shifts, gctx and dshift f32
// (bf16 == 0) or bf16 (bf16 == 1, then dpacked16 [B,N,nB*2C] bf16 receives
// dpacked rounded; null for f32). dpacked is zeroed here, on the same
// stream, before the adds. Requires 1 <= K <= 64 (checked by the Python
// wrapper).
MPA_EXPORT int mpa_transition_attention_bwd(const void* packed, const void* idx,
                                            const void* shifts, const void* gctx, void* dpacked,
                                            void* dpacked16, void* dshift, int B, int N, int S,
                                            int K, int n_branches, int C, int bf16,
                                            void* stream) {
  if (bf16 && dpacked16 == nullptr) return cudaErrorInvalidValue;
  if (bf16)
    return launch<mpa::bf16>(packed, idx, shifts, gctx, dpacked, dpacked16, dshift, B, N, S, K,
                             n_branches, C, mpa::as_stream(stream));
  return launch<float>(packed, idx, shifts, gctx, dpacked, nullptr, dshift, B, N, S, K,
                       n_branches, C, mpa::as_stream(stream));
}
