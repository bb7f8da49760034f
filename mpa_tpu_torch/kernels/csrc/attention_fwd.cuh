// The one-pass body of the attention forward kernels
// (transition_attention_fwd_kernel in attention.cu, whose header spells out
// the contract, and windowed_attention_fwd_kernel in window_attention.cu).
//
// One block per (batch, tile of consecutive queries); the block stages its
// queries' K indices in shared memory once; threads run across the output
// channels, so each gathered row is read by neighbouring threads at
// neighbouring addresses (coalesced). Templated on KMAX (8, 16, 32, 64; a
// runtime K <= KMAX is masked) and VEC: a thread issues all its K (E, V)
// loads up front into registers, then takes the denominator and the maximum
// from registers, so each (E, V) pair is read once. VEC > 1: a thread owns
// VEC channels and moves them as one 16-byte load of E, of V and of the
// shift and one 16-byte store (four floats, or eight bf16; bf16 also takes
// four, as 8-byte moves), where C % VEC == 0, packed, shifts and out are
// aligned to VEC values and K <= 16: ops/attention.py::attention_fwd_form
// picks it, and launch_attention_fwd refuses it otherwise; VEC = 1 for
// every other shape. The denominator starts from E_0 and adds in neighbour
// order, every operation separately rounded (no FMA), the maximum starts
// from -inf: the plain version's order (ops/attention.py::attention_plain),
// so the two agree bit for bit.
// Storage T: float, or bf16 for packed, shifts and out alike (the mixed
// precision models'): the rows stay in registers as the bf16 words they
// were loaded as (Bf16Lanes: eight channels in the four registers that four
// floats take), each value is widened to f32 where it is read, the
// arithmetic is the f32 one above, and the context is rounded to bf16 once,
// as it is stored (attention_pallas.py:602-623 upcasts each tile and casts
// its f32 context to the storage type).
#pragma once

#include "common.cuh"

namespace mpa {

constexpr int kAttentionFwdThreads = 256;

// A thread's VEC channels of one float row, as loaded.
template <int VEC>
struct F32Lanes {
  float x[VEC];
  __device__ __forceinline__ float operator[](int i) const { return x[i]; }
};

template <typename T, int VEC>
using AttentionLanes =
    typename std::conditional<std::is_same<T, float>::value, F32Lanes<VEC>, Bf16Lanes<VEC>>::type;

template <int VEC>
__device__ __forceinline__ void attention_load(const float* p, F32Lanes<VEC>& l) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    l.x[0] = v.x;
    l.x[1] = v.y;
    l.x[2] = v.z;
    l.x[3] = v.w;
  } else {
    l.x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void attention_load(const bf16* p, Bf16Lanes<VEC>& l) {
  l.load(p);
}

template <int VEC>
__device__ __forceinline__ void attention_store(bf16* p, const float (&x)[VEC]) {
  store_bf16<VEC>(p, x);
}

template <int VEC>
__device__ __forceinline__ void attention_store(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// Three blocks an SM where the rows fit 85 registers (at most 32 registers
// of E a thread: K <= 8 at four float channels or eight bf16, K <= 16 at
// four bf16, K <= 32 at one channel): the loads of one block then overlap
// the arithmetic of another (measured 18% faster than two blocks an SM,
// PERF.md section 6; four spill). Each kernel that runs the body declares
// __launch_bounds__(kAttentionFwdThreads,
//                   attention_fwd_min_blocks(KMAX, VEC, sizeof(T))).
constexpr int attention_fwd_min_blocks(int kmax, int vec, int elem) {
  return kmax * ((vec * elem + 3) / 4) <= 32 ? 3 : 1;
}

template <int KMAX, int VEC, typename T>
__device__ __forceinline__ void attention_fwd_body(
    const T* __restrict__ packed, const int* __restrict__ idx,
    const T* __restrict__ shifts, T* __restrict__ out,
    int N, int S, int K, int n_branches, int C) {
  constexpr float kEps = 1e-20f;  // attention_pallas.py _EPS: the denominator floor
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

  const T* pb = packed + static_cast<size_t>(b) * N * W;
  const size_t orow = (static_cast<size_t>(b) * S + s) * Wo;
  for (int oc = tx * VEC; oc < Wo; oc += blockDim.x * VEC) {
    const int r = oc / C;
    const int e_off = 2 * r * C + (oc - r * C);
    const int v_off = e_off + C;
    AttentionLanes<T, VEC> e[KMAX], v[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const T* row = pb + static_cast<size_t>(my_idx[k]) * W;
        attention_load(row + e_off, e[k]);
        attention_load(row + v_off, v[k]);
      }
    }
    AttentionLanes<T, VEC> shift;
    if (shifts != nullptr) attention_load(shifts + orow + oc, shift);
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
    attention_store(out + orow + oc, m);
  }
}

template <typename T>
using AttentionFwdKernel = void (*)(const T*, const int*, const T*, T*, int, int, int, int, int);

// One kernel's instantiations for storage T: eight channels a thread at KMAX
// 8 and 16 (bf16 only: null for float), four at KMAX 8 and 16, one at KMAX
// 8, 16, 32 and 64.
template <typename T>
struct AttentionFwdKernels {
  AttentionFwdKernel<T> vec8[2];
  AttentionFwdKernel<T> vec4[2];
  AttentionFwdKernel<T> vec1[4];
};

// Launch the least KMAX that holds K, at vec channels a thread: threads
// across the output slots (a power of two, at most 128), the rest of 256
// across consecutive queries; shared memory for the block's indices.
// vec = 4, or 8 for bf16, needs C % vec == 0, K <= 16 and packed, shifts and
// out aligned to vec values (16 bytes, or 8 for four bf16), else
// cudaErrorInvalidValue; vec = 1 takes any shape.
template <typename T>
inline cudaError_t launch_attention_fwd(const AttentionFwdKernels<T>& kernels, const void* packed,
                                        const void* idx, const void* shifts, void* out, int B,
                                        int N, int S, int K, int n_branches, int C, int vec,
                                        cudaStream_t st) {
  if (B == 0 || S == 0 || n_branches * C == 0) return cudaGetLastError();
  const auto misaligned = [vec](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (vec * sizeof(T)) != 0;
  };
  const AttentionFwdKernel<T>* wide = vec == 8 ? kernels.vec8 : vec == 4 ? kernels.vec4 : nullptr;
  AttentionFwdKernel<T> kernel;
  if (vec == 1) {
    kernel = kernels.vec1[K <= 8 ? 0 : K <= 16 ? 1 : K <= 32 ? 2 : 3];
  } else if (wide != nullptr && wide[0] != nullptr && C % vec == 0 && K <= 16 &&
             !misaligned(packed) && !misaligned(out) &&
             (shifts == nullptr || !misaligned(shifts))) {
    kernel = wide[K <= 8 ? 0 : 1];
  } else {
    return cudaErrorInvalidValue;
  }
  const int slots = n_branches * C / vec;
  int tx = 1;
  while (tx < slots && tx < 128) tx *= 2;
  const dim3 block(tx, kAttentionFwdThreads / tx);
  const dim3 grid(ceil_div(S, block.y), B);
  const size_t smem = sizeof(int) * static_cast<size_t>(block.y) * K;
  kernel<<<grid, block, smem, st>>>(
      static_cast<const T*>(packed), static_cast<const int*>(idx),
      static_cast<const T*>(shifts), static_cast<T*>(out), N, S, K, n_branches, C);
  return cudaGetLastError();
}

}  // namespace mpa
