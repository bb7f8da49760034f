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
// operations per gathered float. Measured on an H100 it runs at several
// times that bound and about three times the forward kernel on the same
// shapes, its time scaling with B*S*K*C; whether its one atomic add per
// (query, neighbour, channel), made even where dE is only -corr, or its
// repeated row reads set that is not yet measured apart.
// Design: as the forward kernel, one block per (batch, tile
// of queries), the queries' K indices staged in shared memory, threads
// across the output channels so every row read and every atomic add of a
// warp touches neighbouring addresses. A thread recomputes denom, attn, the
// maximum and its tie set (a 64-bit mask, K <= 64) in registers, re-reading
// the K packed rows (L1/L2 hold them) instead of keeping a [B,S,K,W] edge
// tensor, writes dshift directly and adds the dE/dV rows into the zeroed
// f32 dpacked with atomicAdd. Adds from different queries land in no fixed
// order, so dpacked can differ from a sequential sum in the last bits. The
// TPU's one-hot matmul scatter and its bf16 gradient rounding
// (GRAD_SCATTER_PRECISION) are not carried over: every add is f32.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor

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
    // The forward's denominator, summed in the same order.
    float denom = pb[static_cast<size_t>(my_idx[0]) * W + e_off];
    for (int k = 1; k < K; ++k)
      denom = __fadd_rn(denom, pb[static_cast<size_t>(my_idx[k]) * W + e_off]);
    const float den = fmaxf(denom, kEps);
    const float shift = shifts != nullptr ? shifts[orow + oc] : 0.f;

    // The maximum of w over K and the set of neighbours that reach it.
    float m = -INFINITY;
    unsigned long long ties = 0ull;
    for (int k = 0; k < K; ++k) {
      const float* row = pb + static_cast<size_t>(my_idx[k]) * W;
      float v = row[v_off];
      if (shifts != nullptr) v = __fadd_rn(v, shift);
      const float attn = __fsub_rn(__fdiv_rn(row[e_off], den), 1.f);
      const float w = __fmul_rn(attn, v);
      if (w > m) {
        m = w;
        ties = 1ull << k;
      } else if (w == m) {
        ties |= 1ull << k;
      }
    }
    const float cnt = static_cast<float>(__popcll(ties));
    const float dw = __fmul_rn(__fdiv_rn(1.f, cnt), gctx[orow + oc]);

    // t = sum_k dattn_k * E_k and dshift = sum_k dV_k; both vanish off the ties.
    float t = 0.f, ds = 0.f;
    for (int k = 0; k < K; ++k) {
      if (!((ties >> k) & 1ull)) continue;
      const float* row = pb + static_cast<size_t>(my_idx[k]) * W;
      float v = row[v_off];
      if (shifts != nullptr) v = __fadd_rn(v, shift);
      const float e = row[e_off];
      const float attn = __fsub_rn(__fdiv_rn(e, den), 1.f);
      t = __fadd_rn(t, __fmul_rn(__fmul_rn(dw, v), e));
      ds = __fadd_rn(ds, __fmul_rn(dw, attn));
    }
    const float corr = denom >= kEps ? __fdiv_rn(t, __fmul_rn(den, den)) : 0.f;

    for (int k = 0; k < K; ++k) {
      const size_t n = static_cast<size_t>(my_idx[k]) * W;
      if ((ties >> k) & 1ull) {
        const float* row = pb + n;
        float v = row[v_off];
        if (shifts != nullptr) v = __fadd_rn(v, shift);
        const float attn = __fsub_rn(__fdiv_rn(row[e_off], den), 1.f);
        atomicAdd(db + n + e_off, __fsub_rn(__fdiv_rn(__fmul_rn(dw, v), den), corr));
        atomicAdd(db + n + v_off, __fmul_rn(dw, attn));
      } else {
        atomicAdd(db + n + e_off, -corr);  // dattn_k = 0: dE_k = 0 / den - corr
      }
    }
    if (dshift != nullptr) dshift[orow + oc] = ds;
  }
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
  int tx = mpa::ceil_div(Wo, 32) * 32;
  if (tx > 256) tx = 256;
  const int ty = 256 / tx;
  dim3 block(tx, ty);
  dim3 grid(mpa::ceil_div(S, ty), B);
  const size_t smem = sizeof(int) * static_cast<size_t>(ty) * K;
  transition_attention_bwd_kernel<<<grid, block, smem, st>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const float*>(shifts), static_cast<const float*>(gctx),
      static_cast<float*>(dpacked), static_cast<float*>(dshift), N, S, K, n_branches, C);
  return cudaGetLastError();
}
