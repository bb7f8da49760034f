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
// window (window.cuh). An index outside the window is read and added like
// any other, so the result stays right. bf16 storage (the mixed precision
// models'): packed, shifts and gctx bf16 -> dshift bf16, rounded once, and
// dpacked summed in f32 and rounded once into bf16 by a second pass
// (window_attention.py:339,353 and :465-466,504 with _wattn_bwd_rule's
// cast). The TPU kernel's bf16 rounding of each edge gradient before its
// one-hot matmul scatter (GRAD_SCATTER_PRECISION, :367-368) is a
// matrix-unit workaround and is not carried over: every add is f32.
//
// What bounds it on the H100: bytes (packed, idx and gctx and shifts read
// once, dpacked and dshift written once). Design: the one pass of
// attention_bwd.cuh, the exact kernel's: each (query, channel) thread reads
// its K neighbours' E and V once into registers and adds each dE (and a
// tie's dV) straight into the zeroed dpacked with one atomicAdd; the
// window only makes the gathers local (consecutive queries of a Morton
// chunk name overlapping rows). The design before this one staged each
// padded chunk's whole window (2*bn rows of E and V) in shared memory a
// channel tile at a time, read each neighbour there in three passes, and
// added into two zeroed shared band arrays that it wrote back with global
// atomics. Measured on an NVIDIA H100 80GB HBM3 at 700 W over the semseg
// train step's 17 launches (profile_port.py --kernels against copies with
// one part cut; PERF.md section 6): the staging was 30% of that design's
// time, the band's zeroing and write-back 2%, one pass of reads 7%, the
// memset 3%; this one takes 41% of its time. Four channels a thread
// (float4 loads and float4 atomicAdd) measured 37% slower than one, and is
// not kept. Adds from different queries land in no fixed order, so dpacked
// can differ from a sequential sum in the last bits.
#include "attention_bwd.cuh"
#include "common.cuh"

namespace {

template <int KMAX, typename T>
__global__ void windowed_attention_bwd_kernel(
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
      windowed_attention_bwd_kernel<8, T>, windowed_attention_bwd_kernel<16, T>,
      windowed_attention_bwd_kernel<32, T>, windowed_attention_bwd_kernel<64, T>};
  return mpa::launch_attention_bwd(kernels, packed, idx, shifts, gctx, dpacked, dpacked16, dshift,
                                   B, N, S, K, n_branches, C, st);
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32 in [0, N), shifts [B,S,nB*C] or null,
// gctx [B,S,nB*C], dpacked [B,N,nB*2C] f32, dshift [B,S,nB*C] (null exactly
// when shifts is null); all contiguous; packed, shifts, gctx and dshift f32
// (bf16 == 0) or bf16 (bf16 == 1, then dpacked16 [B,N,nB*2C] bf16 receives
// dpacked rounded; null for f32). dpacked is zeroed here, on the same
// stream, before the adds. Requires 1 <= K <= 64 (checked by the Python
// wrapper).
MPA_EXPORT int mpa_windowed_attention_bwd(const void* packed, const void* idx,
                                          const void* shifts, const void* gctx, void* dpacked,
                                          void* dpacked16, void* dshift, int B, int N, int S,
                                          int K, int n_branches, int C, int bf16, void* stream) {
  if (bf16 && dpacked16 == nullptr) return cudaErrorInvalidValue;
  if (bf16)
    return launch<mpa::bf16>(packed, idx, shifts, gctx, dpacked, dpacked16, dshift, B, N, S, K,
                             n_branches, C, mpa::as_stream(stream));
  return launch<float>(packed, idx, shifts, gctx, dpacked, nullptr, dshift, B, N, S, K,
                       n_branches, C, mpa::as_stream(stream));
}
