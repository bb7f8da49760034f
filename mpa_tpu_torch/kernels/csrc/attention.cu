// transition_attention_fwd_kernel: gather + transition attention forward.
//
// Replaces two TPU kernels that compute one function:
// mpa_tpu/ops/pallas/attention_pallas.py::_fused_small_fwd (kernel body
// _fused_small_fwd_kernel, N <= 512, gather done in-kernel as a one-hot
// matmul) and ::_fwd_pallas (kernel body _fwd_kernel, N > 512, over a
// pre-gathered [B,S,K,W] edge tensor). Contract (attention_pallas.py
// transition_attention / _xla_reference): packed [B,N,nB*2C] f32 holding
// [E_r || V_r] per branch r, idx [B,S,K] int32, shifts [B,S,nB*C] f32 or
// null -> ctx [B,S,nB*C] f32 (or all three bf16: the arithmetic stays f32,
// the context is rounded to bf16 once) with, per branch and channel,
//   denom = sum_k E,  attn = E / max(denom, 1e-20) - 1,
//   ctx   = max_k(attn * (V + shift)).
// The denominator starts from E_0 and adds in neighbour order, every
// operation separately rounded (no FMA), the maximum starts from -inf:
// ops/attention.py::attention_plain's order, so the two agree bit for bit.
//
// What bounds it on the H100: bytes. Each (query, neighbour) reads one
// packed row; the arithmetic is a few operations per gathered float. The
// rows are gathered, so they come from L2, and the loads in flight and the
// IEEE divides, not the unique bytes, set the time: on an NVIDIA H100 80GB
// HBM3 at 700 W (profile_port.py --kernels, PERF.md section 6),
// markov_cls's 11 launches take about 0.23 ms and markov_partseg's 17
// about 0.62 (0.38 and 1.00 for the two-pass kernel before this one;
// bounds 0.097 and 0.241); a copy without the arithmetic is 28% faster,
// one that reads half the bytes 29%.
//
// Design: the one pass of attention_fwd.cuh, shared with the windowed
// forward: each (query, channel) thread, or four channels a thread, loads
// its K (E, V) pairs once into registers. No [B,S,K,W] edge tensor is
// written. The TPU's one-hot matmul gather and its bf16 hi/mid/lo split are
// matrix-unit workarounds and are not carried over.
#include "attention_fwd.cuh"
#include "common.cuh"

namespace {

template <int KMAX, int VEC, typename T>
__global__ void __launch_bounds__(mpa::kAttentionFwdThreads,
                                  mpa::attention_fwd_min_blocks(KMAX, VEC, sizeof(T)))
transition_attention_fwd_kernel(
    const T* __restrict__ packed, const int* __restrict__ idx,
    const T* __restrict__ shifts, T* __restrict__ out,
    int N, int S, int K, int n_branches, int C) {
  mpa::attention_fwd_body<KMAX, VEC>(packed, idx, shifts, out, N, S, K, n_branches, C);
}

// Eight channels a thread for bf16 alone: sixteen bytes of float are four.
template <typename T>
const mpa::AttentionFwdKernels<T>& kernels() {
  constexpr bool kBf16 = std::is_same<T, mpa::bf16>::value;
  static const mpa::AttentionFwdKernels<T> k = {
      {kBf16 ? transition_attention_fwd_kernel<8, 8, T> : nullptr,
       kBf16 ? transition_attention_fwd_kernel<16, 8, T> : nullptr},
      {transition_attention_fwd_kernel<8, 4, T>, transition_attention_fwd_kernel<16, 4, T>},
      {transition_attention_fwd_kernel<8, 1, T>, transition_attention_fwd_kernel<16, 1, T>,
       transition_attention_fwd_kernel<32, 1, T>, transition_attention_fwd_kernel<64, 1, T>}};
  return k;
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32, shifts [B,S,nB*C] or null,
// out [B,S,nB*C]; all contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1) except
// idx. Requires 1 <= K <= 64 (checked by the Python wrapper). vec: 4, or 8
// for bf16, needs C % vec == 0, K <= 16 and packed, shifts and out aligned
// to vec values, else cudaErrorInvalidValue; 1 takes any shape.
MPA_EXPORT int mpa_transition_attention_fwd(const void* packed, const void* idx,
                                            const void* shifts, void* out, int B, int N,
                                            int S, int K, int n_branches, int C, int vec,
                                            int bf16, void* stream) {
  if (bf16)
    return mpa::launch_attention_fwd(kernels<mpa::bf16>(), packed, idx, shifts, out, B, N, S, K,
                                     n_branches, C, vec, mpa::as_stream(stream));
  return mpa::launch_attention_fwd(kernels<float>(), packed, idx, shifts, out, B, N, S, K,
                                   n_branches, C, vec, mpa::as_stream(stream));
}
