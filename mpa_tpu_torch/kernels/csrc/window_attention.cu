// windowed_attention_fwd_kernel: transition attention forward over a
// window-constrained neighbour index.
//
// Replaces mpa_tpu/ops/pallas/window_attention.py::_wattn_fwd (kernel body
// _wattn_fwd_kernel). Contract: the function of transition_attention_fwd_
// kernel (attention.cu), packed [B,N,nB*2C] f32 holding [E_r || V_r] per
// branch r, idx [B,S,K] int32, shifts [B,S,nB*C] f32 or null -> ctx
// [B,S,nB*C] f32 (or all three bf16, the mixed precision models': the
// arithmetic stays f32 and the context is rounded to bf16 once, as
// window_attention.py:298,308,311 upcasts the band and the shift and casts
// its f32 context to packed's type) with, per branch and channel,
//   denom = sum_k E (in neighbour order),  attn = E / max(denom, 1e-20) - 1,
//   ctx   = max_k(attn * (V + shift)),
// for an idx whose row s lies in its query chunk's Morton window (WindowSpec
// in ops/window.py, window.cuh). An index outside that window is read like
// any other, so the result is right for any idx in [0, N); it is never
// dropped, as the TPU kernel's one-hot band would drop it.
//
// What bounds it on the H100: bytes (packed, idx and shifts read once, ctx
// written once); the arithmetic is a few operations per gathered float.
// Design: the window is a locality fact, not a staging obligation. The
// kernel runs the exact forward's one pass (attention_fwd.cuh): a block
// takes 8 or 16 consecutive queries, which lie in one padded chunk where
// that count divides sq/2 (the chunks' edges fall on multiples of sq/2) and
// in Morton order name mostly the same rows, so the gathered rows come
// from L1 and L2 while they are hot; each thread loads its K (E, V) pairs
// once into registers, one or four channels a thread
// (ops/attention.py::attention_fwd_form). The design before this
// one staged each padded chunk's window in shared memory, a channel tile of
// at most 32 (16 at semseg's 512-row windows) at a time: every row was
// staged by about two chunks and once for each of n_branches * C / 16
// tiles, and every E was read twice behind an in-window test.
#include "attention_fwd.cuh"
#include "common.cuh"

namespace {

template <int KMAX, int VEC, typename T>
__global__ void __launch_bounds__(mpa::kAttentionFwdThreads,
                                  mpa::attention_fwd_min_blocks(KMAX, VEC, sizeof(T)))
windowed_attention_fwd_kernel(
    const T* __restrict__ packed, const int* __restrict__ idx,
    const T* __restrict__ shifts, T* __restrict__ out,
    int N, int S, int K, int n_branches, int C) {
  mpa::attention_fwd_body<KMAX, VEC>(packed, idx, shifts, out, N, S, K, n_branches, C);
}

// Eight channels a thread for bf16 alone, as attention.cu's table.
template <typename T>
const mpa::AttentionFwdKernels<T>& kernels() {
  constexpr bool kBf16 = std::is_same<T, mpa::bf16>::value;
  static const mpa::AttentionFwdKernels<T> k = {
      {kBf16 ? windowed_attention_fwd_kernel<8, 8, T> : nullptr,
       kBf16 ? windowed_attention_fwd_kernel<16, 8, T> : nullptr},
      {windowed_attention_fwd_kernel<8, 4, T>, windowed_attention_fwd_kernel<16, 4, T>},
      {windowed_attention_fwd_kernel<8, 1, T>, windowed_attention_fwd_kernel<16, 1, T>,
       windowed_attention_fwd_kernel<32, 1, T>, windowed_attention_fwd_kernel<64, 1, T>}};
  return k;
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32 in [0, N), shifts [B,S,nB*C] or null,
// out [B,S,nB*C]; all contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1) except
// idx. Requires 1 <= K <= 64 (checked by the Python wrapper). vec: as
// mpa_transition_attention_fwd takes it (4, or 8 for bf16, or 1).
MPA_EXPORT int mpa_windowed_attention_fwd(const void* packed, const void* idx, const void* shifts,
                                          void* out, int B, int N, int S, int K, int n_branches,
                                          int C, int vec, int bf16, void* stream) {
  if (bf16)
    return mpa::launch_attention_fwd(kernels<mpa::bf16>(), packed, idx, shifts, out, B, N, S, K,
                                     n_branches, C, vec, mpa::as_stream(stream));
  return mpa::launch_attention_fwd(kernels<float>(), packed, idx, shifts, out, B, N, S, K,
                                   n_branches, C, vec, mpa::as_stream(stream));
}
