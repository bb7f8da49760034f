// transition_attention_fwd_kernel: gather + transition attention forward.
//
// Replaces two TPU kernels that compute one function:
// mpa_tpu/ops/pallas/attention_pallas.py::_fused_small_fwd (kernel body
// _fused_small_fwd_kernel, N <= 512, gather done in-kernel as a one-hot
// matmul) and ::_fwd_pallas (kernel body _fwd_kernel, N > 512, over a
// pre-gathered [B,S,K,W] edge tensor). Contract (attention_pallas.py
// transition_attention / _xla_reference): packed [B,N,nB*2C] f32 holding
// [E_r || V_r] per branch r, idx [B,S,K] int32, shifts [B,S,nB*C] f32 or
// null -> ctx [B,S,nB*C] f32 with, per branch and channel,
//   denom = sum_k E,  attn = E / max(denom, 1e-20) - 1,
//   ctx   = max_k(attn * (V + shift)).
//
// What bounds it on the H100: bytes. Each (query, neighbour) reads one packed
// row; the arithmetic is a few operations per gathered float. Design: one
// block per (batch, tile of queries); the block stages each query's K
// indices in shared memory once, then threads run across the output
// channels, so each gathered packed row is read by neighbouring threads at
// neighbouring addresses (coalesced), straight from device memory (L1/L2 hold
// the rows that neighbouring queries share). No [B,S,K,W] edge tensor is ever
// written. The TPU's one-hot matmul gather and its bf16 hi/mid/lo split are
// matrix-unit workarounds and are not carried over.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor

__global__ void transition_attention_fwd_kernel(
    const float* __restrict__ packed, const int* __restrict__ idx,
    const float* __restrict__ shifts, float* __restrict__ out,
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
  const size_t orow = (static_cast<size_t>(b) * S + s) * Wo;
  for (int oc = tx; oc < Wo; oc += blockDim.x) {
    const int r = oc / C;
    const int e_off = 2 * r * C + (oc - r * C);
    const int v_off = e_off + C;
    float denom = pb[static_cast<size_t>(my_idx[0]) * W + e_off];
    for (int k = 1; k < K; ++k)
      denom = __fadd_rn(denom, pb[static_cast<size_t>(my_idx[k]) * W + e_off]);
    const float den = fmaxf(denom, kEps);
    const float shift = shifts != nullptr ? shifts[orow + oc] : 0.f;
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const float* row = pb + static_cast<size_t>(my_idx[k]) * W;
      float v = row[v_off];
      if (shifts != nullptr) v = __fadd_rn(v, shift);
      const float attn = __fsub_rn(__fdiv_rn(row[e_off], den), 1.f);
      m = fmaxf(m, __fmul_rn(attn, v));
    }
    out[orow + oc] = m;
  }
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32, shifts [B,S,nB*C] or null,
// out [B,S,nB*C]; all contiguous f32 except idx. Requires 1 <= K <= 64
// (checked by the Python wrapper).
MPA_EXPORT int mpa_transition_attention_fwd(const void* packed, const void* idx,
                                            const void* shifts, void* out, int B, int N,
                                            int S, int K, int n_branches, int C,
                                            void* stream) {
  const int Wo = n_branches * C;
  int tx = mpa::ceil_div(Wo, 32) * 32;
  if (tx > 256) tx = 256;
  const int ty = 256 / tx;
  dim3 block(tx, ty);
  dim3 grid(mpa::ceil_div(S, ty), B);
  const size_t smem = sizeof(int) * static_cast<size_t>(ty) * K;
  transition_attention_fwd_kernel<<<grid, block, smem, mpa::as_stream(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const float*>(shifts), static_cast<float*>(out), N, S, K, n_branches, C);
  return cudaGetLastError();
}
