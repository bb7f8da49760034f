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
// Design: one block per (batch, tile of queries); the block stages its
// queries' K indices in shared memory once; threads run across the output
// channels, so each gathered row is read by neighbouring threads at
// neighbouring addresses (coalesced). One pass, templated on KMAX (8, 16,
// 32, 64; a runtime K <= KMAX is masked): a thread issues all its K (E, V)
// loads up front into registers, then takes the denominator and the
// maximum from registers, so each (E, V) pair is read once. VEC = 4: a
// thread owns four channels, float4 loads of E, V and the shift and a
// float4 store (C % 4 == 0, 16-byte aligned packed and shifts, K <= 16:
// ops/attention.py::attention_fwd_form picks it, and this entry refuses it
// otherwise); VEC = 1 for every other shape. No [B,S,K,W] edge tensor is
// written. The TPU's one-hot matmul gather and its bf16 hi/mid/lo split
// are matrix-unit workarounds and are not carried over.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor
constexpr int THREADS = 256;

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// Three blocks an SM where the rows fit 85 registers (K <= 8 at four
// channels, K <= 32 at one): the loads of one block then overlap the
// arithmetic of another (measured 18% faster than two blocks an SM, PERF.md
// section 6; four spill).
template <int KMAX, int VEC>
__global__ void __launch_bounds__(THREADS, KMAX * VEC <= 32 ? 3 : 1)
transition_attention_fwd_kernel(
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
  for (int oc = tx * VEC; oc < Wo; oc += blockDim.x * VEC) {
    const int r = oc / C;
    const int e_off = 2 * r * C + (oc - r * C);
    const int v_off = e_off + C;
    float e[KMAX][VEC], v[KMAX][VEC];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float* row = pb + static_cast<size_t>(my_idx[k]) * W;
        load(row + e_off, e[k]);
        load(row + v_off, v[k]);
      }
    }
    float shift[VEC];
    if (shifts != nullptr) load(shifts + orow + oc, shift);
    float m[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float denom = e[0][i];
#pragma unroll
      for (int k = 1; k < KMAX; ++k) {
        if (k < K) denom = __fadd_rn(denom, e[k][i]);
      }
      const float den = fmaxf(denom, kEps);
      m[i] = -INFINITY;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const float vk = shifts != nullptr ? __fadd_rn(v[k][i], shift[i]) : v[k][i];
          const float attn = __fsub_rn(__fdiv_rn(e[k][i], den), 1.f);
          m[i] = fmaxf(m[i], __fmul_rn(attn, vk));
        }
      }
    }
    store(out + orow + oc, m);
  }
}

template <int VEC>
cudaError_t launch(const void* packed, const void* idx, const void* shifts, void* out, int B,
                   int N, int S, int K, int n_branches, int C, cudaStream_t st) {
  // Threads across the output slots (a power of two, at most 128), the rest
  // of 256 across queries.
  const int slots = n_branches * C / VEC;
  int tx = 1;
  while (tx < slots && tx < 128) tx *= 2;
  const dim3 block(tx, THREADS / tx);
  const dim3 grid(mpa::ceil_div(S, block.y), B);
  const size_t smem = sizeof(int) * static_cast<size_t>(block.y) * K;
  auto kernel = K <= 8 ? transition_attention_fwd_kernel<8, VEC>
                       : transition_attention_fwd_kernel<16, VEC>;
  if constexpr (VEC == 1) {  // four channels a thread stop at K = 16 (128 registers of rows)
    if (K > 16)
      kernel = K <= 32 ? transition_attention_fwd_kernel<32, 1>
                       : transition_attention_fwd_kernel<64, 1>;
  }
  kernel<<<grid, block, smem, st>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<const float*>(shifts), static_cast<float*>(out), N, S, K, n_branches, C);
  return cudaGetLastError();
}

}  // namespace

// packed [B,N,nB*2C], idx [B,S,K] int32, shifts [B,S,nB*C] or null,
// out [B,S,nB*C]; all contiguous f32 except idx. Requires 1 <= K <= 64
// (checked by the Python wrapper). vec: 4 needs C % 4 == 0, K <= 16 and
// 16-byte aligned packed, shifts and out, else cudaErrorInvalidValue; 1
// takes any shape.
MPA_EXPORT int mpa_transition_attention_fwd(const void* packed, const void* idx,
                                            const void* shifts, void* out, int B, int N,
                                            int S, int K, int n_branches, int C, int vec,
                                            void* stream) {
  if (B == 0 || S == 0 || n_branches * C == 0) return cudaGetLastError();
  cudaStream_t st = mpa::as_stream(stream);
  if (vec == 1)
    return launch<1>(packed, idx, shifts, out, B, N, S, K, n_branches, C, st);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (vec != 4 || C % 4 != 0 || K > 16 || misaligned(packed) || misaligned(out) ||
      (shifts != nullptr && misaligned(shifts)))
    return cudaErrorInvalidValue;
  return launch<4>(packed, idx, shifts, out, B, N, S, K, n_branches, C, st);
}
