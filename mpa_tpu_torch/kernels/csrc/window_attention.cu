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
// in ops/window.py): [g*bn, g*bn + 2*bn), g = clamp(c - 1, 0, n_chunks - 2),
// c = (s + sq/2) / sq. An index outside that window is still read, from
// device memory, so the result is right for any idx in [0, N); it is only
// slower. It is never dropped, as the TPU kernel's one-hot band would drop
// it.
//
// What bounds it on the H100: bytes (packed, idx and shifts read once, ctx
// written once); the arithmetic is a few operations per gathered float. The
// window is a locality fact: a chunk of sq queries reads only 2*bn rows.
// Design: one block per (cloud, padded chunk, tile of up to 32 channels of
// one branch). It stages the window's E and V columns of its tile in shared
// memory (coalesced rows) and the chunk's indices beside them, then threads
// run over (query, channel) pairs, channels fastest, and gather the K
// neighbours from shared memory. The denominator is summed in neighbour
// order with separately rounded adds, as attention.cu and the plain version
// (ops/attention.py::attention_plain) do, so all three agree bit for bit.
#include "common.cuh"
#include "window.cuh"

namespace {

constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
windowed_attention_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ idx,
                              const float* __restrict__ shifts, float* __restrict__ out, int N,
                              int S, int K, int n_branches, int C, int sq, int bn, int n_chunks,
                              int ct) {
  extern __shared__ float smem[];
  const int W = 2 * bn;
  float* e_s = smem;           // [W][ct]
  float* v_s = e_s + W * ct;   // [W][ct]
  int* idx_s = reinterpret_cast<int*>(v_s + W * ct);  // [sq][K]
  const mpa::WindowChunk ch(blockIdx.x, S, sq, bn, n_chunks);
  const int b = blockIdx.z;
  const int tiles = mpa::ceil_div(C, ct);
  const int r = blockIdx.y / tiles, c0 = (blockIdx.y % tiles) * ct;
  const int cw = min(ct, C - c0);  // channels of this tile
  const int Wp = 2 * n_branches * C, Wo = n_branches * C;
  const int e_off = 2 * r * C + c0, v_off = e_off + C;
  const float* pb = packed + static_cast<size_t>(b) * N * Wp;

  for (int i = threadIdx.x; i < W * ct; i += kThreads) {
    const int row = i / ct, j = i - row * ct;
    if (j < cw) {
      const float* src = pb + static_cast<size_t>(ch.win0 + row) * Wp;
      e_s[i] = src[e_off + j];
      v_s[i] = src[v_off + j];
    }
  }
  const int nq = ch.s_hi - ch.s_lo;
  const int* ib = idx + (static_cast<size_t>(b) * S + ch.s_lo) * K;
  for (int i = threadIdx.x; i < nq * K; i += kThreads) idx_s[i] = ib[i];
  __syncthreads();

  for (int p = threadIdx.x; p < nq * ct; p += kThreads) {
    const int q = p / ct, j = p - q * ct;
    if (j >= cw) continue;
    const int* my = idx_s + q * K;
    // Row k's E and V for channel j: from the band, or from device memory
    // for an index outside the window.
    auto local = [&](int k) { return my[k] - ch.win0; };
    auto e_at = [&](int k) {
      const int l = local(k);
      return (l >= 0 && l < W) ? e_s[l * ct + j] : pb[static_cast<size_t>(my[k]) * Wp + e_off + j];
    };
    auto v_at = [&](int k) {
      const int l = local(k);
      return (l >= 0 && l < W) ? v_s[l * ct + j] : pb[static_cast<size_t>(my[k]) * Wp + v_off + j];
    };
    float denom = e_at(0);
    for (int k = 1; k < K; ++k) denom = __fadd_rn(denom, e_at(k));
    const float den = fmaxf(denom, kEps);
    const size_t o = (static_cast<size_t>(b) * S + ch.s_lo + q) * Wo + r * C + c0 + j;
    const float shift = shifts != nullptr ? shifts[o] : 0.f;
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) {
      float v = v_at(k);
      if (shifts != nullptr) v = __fadd_rn(v, shift);
      const float attn = __fsub_rn(__fdiv_rn(e_at(k), den), 1.f);
      m = fmaxf(m, __fmul_rn(attn, v));
    }
    out[o] = m;
  }
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32 in [0, N), shifts [B,S,nB*C] or null,
// out [B,S,nB*C]; all contiguous f32 except idx; the window spec (sq, bn,
// n_chunks) as make_window_spec gives it. Requires 1 <= K <= 64 and
// 2*bn <= mpa::kMaxWindow (checked by the Python wrapper).
MPA_EXPORT int mpa_windowed_attention_fwd(const void* packed, const void* idx, const void* shifts,
                                          void* out, int B, int N, int S, int K, int n_branches,
                                          int C, int sq, int bn, int n_chunks, void* stream) {
  if (B == 0 || S == 0 || C == 0) return cudaGetLastError();
  const int ct = mpa::window_channel_tile(2 * bn, C);
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(2 * bn) * ct +
                      sizeof(int) * static_cast<size_t>(sq) * K;
  cudaError_t err = mpa::allow_smem(windowed_attention_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_chunks + 1, n_branches * mpa::ceil_div(C, ct), B);
  windowed_attention_fwd_kernel<<<grid, kThreads, smem, mpa::as_stream(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const float*>(shifts), static_cast<float*>(out), N, S, K, n_branches, C, sq, bn,
      n_chunks, ct);
  return cudaGetLastError();
}
