// windowed_attention_bwd_kernel: transition attention backward over a
// window-constrained neighbour index, the scatter into the node gradients
// fused in.
//
// Replaces mpa_tpu/ops/pallas/window_attention.py::_wattn_bwd (kernel body
// _wattn_bwd_kernel). Contract: the function of transition_attention_bwd_
// kernel (attention_bwd.cu, whose header spells out the arithmetic: the
// forward's denominator in neighbour order, the maximum over K and its tie
// set with the gradient split equally among the ties, the 1e-20 floor gating
// the denominator's gradient) -> dpacked [B,N,nB*2C] f32 and, with shifts,
// dshift [B,S,nB*C] = sum_k dV_k, for an idx inside its chunk's Morton
// window (window.cuh). An index outside the window is read and added
// straight in device memory, so the result stays right; it is only slower.
//
// What bounds it on the H100: bytes (packed, idx, gctx and shifts read once,
// dpacked and dshift written once). Design: as the forward kernel, one block
// per (cloud, padded chunk, channel tile) stages the window's E and V
// columns in shared memory; beside them two zeroed band accumulators for dE
// and dV. Threads run over (query, channel) pairs, recompute the forward in
// registers and add each neighbour's dE (and, at the ties, dV) into the
// band with shared-memory atomics; then the block adds its band into the
// zeroed dpacked with one global atomicAdd per nonzero entry. A band row
// lies in at most three chunks' windows, so each dpacked entry takes at most
// three global adds, against one per (query, neighbour, channel) in
// attention_bwd.cu. Atomics were chosen over per-chunk partial bands summed
// in a second pass: the adds inside a block already land in no fixed order
// (queries share rows), so a fixed-order second pass would buy no
// determinism, only a [B, n_chunks+1, 2*bn, W] scratch tensor and a launch.
// The sums can therefore differ from a sequential sum in their last bits.
#include "common.cuh"
#include "window.cuh"

namespace {

constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
windowed_attention_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ idx,
                              const float* __restrict__ shifts, const float* __restrict__ gctx,
                              float* __restrict__ dpacked, float* __restrict__ dshift, int N,
                              int S, int K, int n_branches, int C, int sq, int bn, int n_chunks,
                              int ct) {
  extern __shared__ float smem[];
  const int W = 2 * bn;
  float* e_s = smem;            // [W][ct]
  float* v_s = e_s + W * ct;    // [W][ct]
  float* de_s = v_s + W * ct;   // [W][ct] accumulated dE
  float* dv_s = de_s + W * ct;  // [W][ct] accumulated dV
  int* idx_s = reinterpret_cast<int*>(dv_s + W * ct);  // [sq][K]
  const mpa::WindowChunk ch(blockIdx.x, S, sq, bn, n_chunks);
  const int b = blockIdx.z;
  const int tiles = mpa::ceil_div(C, ct);
  const int r = blockIdx.y / tiles, c0 = (blockIdx.y % tiles) * ct;
  const int cw = min(ct, C - c0);
  const int Wp = 2 * n_branches * C, Wo = n_branches * C;
  const int e_off = 2 * r * C + c0, v_off = e_off + C;
  const float* pb = packed + static_cast<size_t>(b) * N * Wp;
  float* db = dpacked + static_cast<size_t>(b) * N * Wp;

  for (int i = threadIdx.x; i < W * ct; i += kThreads) {
    const int row = i / ct, j = i - row * ct;
    if (j < cw) {
      const float* src = pb + static_cast<size_t>(ch.win0 + row) * Wp;
      e_s[i] = src[e_off + j];
      v_s[i] = src[v_off + j];
    }
    de_s[i] = 0.f;
    dv_s[i] = 0.f;
  }
  const int nq = ch.s_hi - ch.s_lo;
  const int* ib = idx + (static_cast<size_t>(b) * S + ch.s_lo) * K;
  for (int i = threadIdx.x; i < nq * K; i += kThreads) idx_s[i] = ib[i];
  __syncthreads();

  for (int p = threadIdx.x; p < nq * ct; p += kThreads) {
    const int q = p / ct, j = p - q * ct;
    if (j >= cw) continue;
    const int* my = idx_s + q * K;
    auto local = [&](int k) { return my[k] - ch.win0; };
    auto inside = [&](int l) { return l >= 0 && l < W; };
    auto e_at = [&](int k) {
      const int l = local(k);
      return inside(l) ? e_s[l * ct + j] : pb[static_cast<size_t>(my[k]) * Wp + e_off + j];
    };
    auto v_at = [&](int k) {
      const int l = local(k);
      return inside(l) ? v_s[l * ct + j] : pb[static_cast<size_t>(my[k]) * Wp + v_off + j];
    };
    // The forward's denominator, summed in the same order.
    float denom = e_at(0);
    for (int k = 1; k < K; ++k) denom = __fadd_rn(denom, e_at(k));
    const float den = fmaxf(denom, kEps);
    const size_t o = (static_cast<size_t>(b) * S + ch.s_lo + q) * Wo + r * C + c0 + j;
    const float shift = shifts != nullptr ? shifts[o] : 0.f;

    // The maximum of w over K and the set of neighbours that reach it.
    float m = -INFINITY;
    unsigned long long ties = 0ull;
    for (int k = 0; k < K; ++k) {
      float v = v_at(k);
      if (shifts != nullptr) v = __fadd_rn(v, shift);
      const float w = __fmul_rn(__fsub_rn(__fdiv_rn(e_at(k), den), 1.f), v);
      if (w > m) {
        m = w;
        ties = 1ull << k;
      } else if (w == m) {
        ties |= 1ull << k;
      }
    }
    const float cnt = static_cast<float>(__popcll(ties));
    const float dw = __fmul_rn(__fdiv_rn(1.f, cnt), gctx[o]);

    // t = sum_k dattn_k * E_k and dshift = sum_k dV_k; both vanish off the ties.
    float t = 0.f, ds = 0.f;
    for (int k = 0; k < K; ++k) {
      if (!((ties >> k) & 1ull)) continue;
      float v = v_at(k);
      if (shifts != nullptr) v = __fadd_rn(v, shift);
      const float e = e_at(k);
      const float attn = __fsub_rn(__fdiv_rn(e, den), 1.f);
      t = __fadd_rn(t, __fmul_rn(__fmul_rn(dw, v), e));
      ds = __fadd_rn(ds, __fmul_rn(dw, attn));
    }
    const float corr = denom >= kEps ? __fdiv_rn(t, __fmul_rn(den, den)) : 0.f;

    for (int k = 0; k < K; ++k) {
      const int l = local(k);
      float de = -corr, dv = 0.f;  // off the ties dattn_k = 0: dE_k = 0 / den - corr
      if ((ties >> k) & 1ull) {
        float v = v_at(k);
        if (shifts != nullptr) v = __fadd_rn(v, shift);
        const float attn = __fsub_rn(__fdiv_rn(e_at(k), den), 1.f);
        de = __fsub_rn(__fdiv_rn(__fmul_rn(dw, v), den), corr);
        dv = __fmul_rn(dw, attn);
      }
      if (inside(l)) {
        atomicAdd(de_s + l * ct + j, de);
        if (dv != 0.f) atomicAdd(dv_s + l * ct + j, dv);
      } else {
        const size_t n = static_cast<size_t>(my[k]) * Wp;
        atomicAdd(db + n + e_off + j, de);
        if (dv != 0.f) atomicAdd(db + n + v_off + j, dv);
      }
    }
    if (dshift != nullptr) dshift[o] = ds;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < W * ct; i += kThreads) {
    const int row = i / ct, j = i - row * ct;
    if (j >= cw) continue;
    float* dst = db + static_cast<size_t>(ch.win0 + row) * Wp;
    if (de_s[i] != 0.f) atomicAdd(dst + e_off + j, de_s[i]);
    if (dv_s[i] != 0.f) atomicAdd(dst + v_off + j, dv_s[i]);
  }
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32 in [0, N), shifts [B,S,nB*C] or null,
// gctx [B,S,nB*C], dpacked [B,N,nB*2C], dshift [B,S,nB*C] (null exactly when
// shifts is null); all contiguous f32 except idx; the window spec (sq, bn,
// n_chunks) as make_window_spec gives it. dpacked is zeroed here, on the
// same stream, before the adds. Requires 1 <= K <= 64 and 2*bn <=
// mpa::kMaxWindow (checked by the Python wrapper).
MPA_EXPORT int mpa_windowed_attention_bwd(const void* packed, const void* idx, const void* shifts,
                                          const void* gctx, void* dpacked, void* dshift, int B,
                                          int N, int S, int K, int n_branches, int C, int sq,
                                          int bn, int n_chunks, void* stream) {
  cudaStream_t st = mpa::as_stream(stream);
  cudaError_t err = cudaMemsetAsync(
      dpacked, 0, sizeof(float) * static_cast<size_t>(B) * N * 2 * n_branches * C, st);
  if (err != cudaSuccess) return err;
  if (B == 0 || S == 0 || C == 0) return cudaGetLastError();
  const int ct = mpa::window_channel_tile(2 * bn, C, 4);
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(2 * bn) * ct +
                      sizeof(int) * static_cast<size_t>(sq) * K;
  err = mpa::allow_smem(windowed_attention_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_chunks + 1, n_branches * mpa::ceil_div(C, ct), B);
  windowed_attention_bwd_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const float*>(shifts), static_cast<const float*>(gctx),
      static_cast<float*>(dpacked), static_cast<float*>(dshift), N, S, K, n_branches, C, sq, bn,
      n_chunks, ct);
  return cudaGetLastError();
}
