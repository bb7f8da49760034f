// windowed_attention_fwd_kernel: transition attention forward over a
// window-constrained neighbour index.
//
// Replaces mpa_tpu/ops/pallas/window_attention.py::_wattn_fwd (kernel body
// _wattn_fwd_kernel). Contract: the function of transition_attention_fwd_
// kernel (attention.cu), packed [B,N,nB*2C] f32 holding [E_r || V_r] per
// branch r, idx [B,S,K] int32, shifts [B,S,nB*C] f32 or null -> ctx
// [B,S,nB*C] f32 with, per branch and channel,
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

template <int KMAX, int VEC>
__global__ void __launch_bounds__(mpa::kAttentionFwdThreads,
                                  mpa::attention_fwd_min_blocks(KMAX, VEC, sizeof(float)))
windowed_attention_fwd_kernel(
    const float* __restrict__ packed, const int* __restrict__ idx,
    const float* __restrict__ shifts, float* __restrict__ out,
    int N, int S, int K, int n_branches, int C) {
  mpa::attention_fwd_body<KMAX, VEC>(packed, idx, shifts, out, N, S, K, n_branches, C);
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32 in [0, N), shifts [B,S,nB*C] or null,
// out [B,S,nB*C]; all contiguous f32 except idx. Requires 1 <= K <= 64
// (checked by the Python wrapper). vec: as mpa_transition_attention_fwd for
// float32 (4 or 1).
MPA_EXPORT int mpa_windowed_attention_fwd(const void* packed, const void* idx, const void* shifts,
                                          void* out, int B, int N, int S, int K, int n_branches,
                                          int C, int vec, void* stream) {
  static const mpa::AttentionFwdKernels<float> kernels = {
      {nullptr, nullptr},
      {windowed_attention_fwd_kernel<8, 4>, windowed_attention_fwd_kernel<16, 4>},
      {windowed_attention_fwd_kernel<8, 1>, windowed_attention_fwd_kernel<16, 1>,
       windowed_attention_fwd_kernel<32, 1>, windowed_attention_fwd_kernel<64, 1>}};
  return mpa::launch_attention_fwd(kernels, packed, idx, shifts, out, B, N, S, K, n_branches, C,
                                   vec, mpa::as_stream(stream));
}
