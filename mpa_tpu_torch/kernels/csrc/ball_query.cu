// ball_query_kernel: the sentinel stage of radius (ball) grouping.
//
// Replaces mpa_tpu/ops/pallas/ball_pallas.py::ball_query_indices_pallas
// (kernel body _ball_kernel). Contract: xyz [B,N,C] f32, new_xyz [B,S,C] f32
// and r2 -> [B,S,nsample] int32: for each centre, the nsample LOWEST-index
// base points whose squared distance is <= r2, in ascending index order, and
// the sentinel N in the slots left over. The caller backfills the sentinels
// (ops/ball_query.py). r2 is a runtime argument: the wrapper rounds
// radius * radius, taken in double, once to float32, as JAX compares
// d <= radius * radius, so any radius runs without a rebuild.
//
// Distances: knn.cu's arithmetic, the expanded form |q|^2 + |b|^2 - 2 q.b,
// each dot product accumulated in channel order with separately rounded
// multiplies and adds (no FMA contraction), which is what
// ops/pairwise.py::square_distance computes. Its clamp at 0 is left out:
// r2 >= 0, so max(d, 0) <= r2 exactly when d <= r2, and a NaN distance
// (NaN or infinite inputs) is out of the ball on both sides. So membership
// equals the plain version's even where a distance lies within a last bit of
// r2.
//
// What bounds it on the H100: the distance tests, (2C + 3) float32
// operations each, on the CUDA cores, one instruction each (none fuses);
// the bytes (the two clouds in, the indices out) are small. The TPU kernel's
// distance tile on the matrix unit and its nsample min-passes over the whole
// tile are not carried over: a warp finds its hits in index order directly.
//
// Design: a block of WARPS warps owns WARPS * G centres of one cloud (G
// centres a warp, ball_query_form in ops/ball_query.py picks G by the
// launch's size) and stages the cloud's rows once for all of them, in tiles
// of at most TILE_BYTES (a 3-channel cloud of up to 4096 points is one
// tile). At C = 3 a staged row is a float4 {x, y, z, |b|^2}: the staging pass
// computes the norm, one thread a row, and a test reads its row with one
// 16-byte load. Rows past N are padded with a NaN norm, which no test
// admits. A warp holds its G centres in registers and walks the staged rows
// in slabs of 32, lane i the slab's row i: each slab's row is read once for
// all G centres, and per centre one __ballot_sync gives the slab's
// in-radius mask, which lane k keeps for slab k of a chunk of 32 slabs (no
// branch among the tests). After the chunk, a scan of the masks' popcounts
// over the lanes gives each slab its first slot and lane k writes slab k's
// hits, so hits land in ascending index order with no sort, for a few
// instructions a chunk and not a slab (a centre averages 8 to 16 hits over
// 32 slabs at the repsurf stages; handled a slab at a time, the hits cost as
// much as the tests). A warp stops after a chunk once each of its centres
// holds nsample hits, the block stops staging tiles once all its warps
// have, and each centre's remaining slots get N. Any other C takes the same
// walk with rows, norms and centres in shared memory (rows at an odd
// stride, so 32 lanes read 32 banks).
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int TILE_BYTES = 64 * 1024;  // staged rows (and norms) a tile
constexpr unsigned FULL = 0xffffffffu;

// XYZ: C == 3, rows as float4 and centres in registers; else any C.
template <int G, bool XYZ>
__global__ void __launch_bounds__(WARPS * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                  int* __restrict__ out, int N, int S, int C, int nsample, float r2,
                  int tile_n, int cstride) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* rows = smem4;                         // XYZ: [tile_n] {x, y, z, |b|^2}
  float* q_s = smem;                            // else: [WARPS * G][C] centres,
  float* bn_s = q_s + WARPS * G * C;            //       [tile_n] norms,
  float* b_s = bn_s + tile_n;                   //       [tile_n][cstride] rows

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int b = blockIdx.y;
  const int sb = blockIdx.x * WARPS * G;        // the block's first centre
  const int s0 = sb + w * G;                    // the warp's first centre
  const float* xb = xyz + static_cast<size_t>(b) * N * C;
  const float* qb = new_xyz + static_cast<size_t>(b) * S * C;
  const float nan = __int_as_float(0x7fffffff);
  const unsigned below = (1u << lane) - 1u;

  if constexpr (!XYZ) {
    const int n_q = min(WARPS * G, S - sb) * C;
    const float* qs = qb + static_cast<size_t>(sb) * C;
    for (int e = t; e < WARPS * G * C; e += blockDim.x) q_s[e] = e < n_q ? qs[e] : 0.f;
    __syncthreads();
  }
  // A centre past S has a NaN norm (no hit) and counts as full.
  float qx[G], qy[G], qz[G], qn[G];
  int count[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool live = s0 + g < S;
    float n2;
    if constexpr (XYZ) {
      const float* q = qb + static_cast<size_t>(live ? s0 + g : 0) * 3;
      qx[g] = q[0], qy[g] = q[1], qz[g] = q[2];
      n2 = __fadd_rn(__fadd_rn(__fmul_rn(qx[g], qx[g]), __fmul_rn(qy[g], qy[g])),
                     __fmul_rn(qz[g], qz[g]));
    } else {
      const float* q = q_s + (w * G + g) * C;
      n2 = __fmul_rn(q[0], q[0]);
      for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(q[c], q[c]));
    }
    qn[g] = live ? n2 : nan;
    count[g] = live ? 0 : nsample;
  }
  int* o = out + (static_cast<size_t>(b) * S + s0) * nsample;

  for (int j0 = 0; j0 < N; j0 += tile_n) {
    bool open = false;  // uniform: the warp has a centre with room
#pragma unroll
    for (int g = 0; g < G; ++g) open = open || count[g] < nsample;
    // Also waits until the previous tile has been consumed.
    if (!__syncthreads_or(open)) break;  // uniform: every warp is done
    const int nt = min(tile_n, N - j0);
    const int nt32 = (nt + 31) & ~31;
    const float* src = xb + static_cast<size_t>(j0) * C;
    for (int r = t; r < nt32; r += blockDim.x) {
      if constexpr (XYZ) {
        float4 v = make_float4(0.f, 0.f, 0.f, nan);
        if (r < nt) {
          v.x = src[3 * r], v.y = src[3 * r + 1], v.z = src[3 * r + 2];
          v.w = __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                          __fmul_rn(v.z, v.z));
        }
        rows[r] = v;
      } else {
        float n2 = nan;
        float* br = b_s + r * cstride;
        if (r < nt) {
          const float* sr = src + static_cast<size_t>(r) * C;
          for (int c = 0; c < C; ++c) {
            const float v = sr[c];
            br[c] = v;
            n2 = c == 0 ? __fmul_rn(v, v) : __fadd_rn(n2, __fmul_rn(v, v));
          }
        } else {
          for (int c = 0; c < C; ++c) br[c] = 0.f;
        }
        bn_s[r] = n2;
      }
    }
    __syncthreads();
    // Chunks of up to 32 slabs. Each slab's test gives one ballot a centre,
    // which lane k keeps for slab k; after the chunk a scan over the lanes
    // gives each slab's first slot, and lane k writes slab k's hits.
    for (int c0 = 0; open && c0 < nt32; c0 += 32 * 32) {  // a full warp skips its tests
      const int n_slabs = min(32, (nt32 - c0) / 32);
      unsigned mine[G];
#pragma unroll
      for (int g = 0; g < G; ++g) mine[g] = 0u;
      for (int k = 0; k < n_slabs; ++k) {
        const int r = c0 + 32 * k + lane;
        float cross[G], bn;
        if constexpr (XYZ) {
          const float4 v = rows[r];
          bn = v.w;
#pragma unroll
          for (int g = 0; g < G; ++g)
            cross[g] = __fadd_rn(__fadd_rn(__fmul_rn(qx[g], v.x), __fmul_rn(qy[g], v.y)),
                                 __fmul_rn(qz[g], v.z));
        } else {
          bn = bn_s[r];
          const float* br = b_s + r * cstride;
          const float* q = q_s + w * G * C;
          float v = br[0];
#pragma unroll
          for (int g = 0; g < G; ++g) cross[g] = __fmul_rn(q[g * C], v);
          for (int c = 1; c < C; ++c) {
            v = br[c];
#pragma unroll
            for (int g = 0; g < G; ++g)
              cross[g] = __fadd_rn(cross[g], __fmul_rn(q[g * C + c], v));
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float d = __fsub_rn(__fadd_rn(qn[g], bn), __fmul_rn(2.f, cross[g]));
          const unsigned m = __ballot_sync(FULL, d <= r2);
          if (lane == k) mine[g] = m;
        }
      }
      bool done = true;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (count[g] < nsample) {  // uniform
          const int n = __popc(mine[g]);
          int upto = n;  // hits of slabs 0..lane
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(FULL, upto, off);
            if (lane >= off) upto += v;
          }
          int slot = count[g] + upto - n;
          const int first = j0 + c0 + 32 * lane;
          for (unsigned m = mine[g]; m && slot < nsample; m &= m - 1u, ++slot)
            o[g * nsample + slot] = first + __ffs(m) - 1;
          count[g] += __shfl_sync(FULL, upto, 31);
        }
        done = done && count[g] >= nsample;
      }
      if (done) break;  // uniform
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (s0 + g >= S) break;
    for (int slot = min(count[g], nsample) + lane; slot < nsample; slot += 32)
      o[g * nsample + slot] = N;
  }
}

template <int G>
cudaError_t launch(const float* xyz, const float* new_xyz, int* out, int B, int N, int S, int C,
                   int nsample, float r2, cudaStream_t stream) {
  const int n_pad = mpa::ceil_div(N, 32) * 32;
  int tile_n, cstride = 0;
  size_t smem;
  if (C == 3) {
    tile_n = n_pad < TILE_BYTES / 16 ? n_pad : TILE_BYTES / 16;
    smem = sizeof(float4) * static_cast<size_t>(tile_n);
  } else {
    cstride = (C % 2 == 0) ? C + 1 : C;  // odd: 32 lanes on 32 banks
    tile_n = (TILE_BYTES / 4 / (cstride + 1)) / 32 * 32;
    tile_n = tile_n < 32 ? 32 : (tile_n > n_pad ? n_pad : tile_n);
    smem = sizeof(float) * (static_cast<size_t>(WARPS) * G * C +
                            static_cast<size_t>(tile_n) * (cstride + 1));
  }
  dim3 grid(mpa::ceil_div(S, WARPS * G), B);
  if (C == 3) {
    cudaError_t err = mpa::allow_smem(ball_query_kernel<G, true>, smem);
    if (err != cudaSuccess) return err;
    ball_query_kernel<G, true><<<grid, WARPS * 32, smem, stream>>>(
        xyz, new_xyz, out, N, S, C, nsample, r2, tile_n, cstride);
  } else {
    cudaError_t err = mpa::allow_smem(ball_query_kernel<G, false>, smem);
    if (err != cudaSuccess) return err;
    ball_query_kernel<G, false><<<grid, WARPS * 32, smem, stream>>>(
        xyz, new_xyz, out, N, S, C, nsample, r2, tile_n, cstride);
  }
  return cudaGetLastError();
}

}  // namespace

// xyz [B,N,C], new_xyz [B,S,C] f32 contiguous -> out [B,S,nsample] int32, G
// centres a warp (1, 2, 4 or 8; ops/ball_query.py::ball_query_form).
// Requires 1 <= B <= 65535, N, S >= 1, 1 <= C <= 256 and nsample >= 1
// (checked by the Python wrapper); r2 is the squared radius in float32.
MPA_EXPORT int mpa_ball_query(const void* xyz, const void* new_xyz, void* out, int B, int N,
                              int S, int C, int nsample, float r2, int G, void* stream) {
  const auto x = static_cast<const float*>(xyz);
  const auto q = static_cast<const float*>(new_xyz);
  const auto o = static_cast<int*>(out);
  cudaStream_t st = mpa::as_stream(stream);
  switch (G) {
    case 1: return launch<1>(x, q, o, B, N, S, C, nsample, r2, st);
    case 2: return launch<2>(x, q, o, B, N, S, C, nsample, r2, st);
    case 4: return launch<4>(x, q, o, B, N, S, C, nsample, r2, st);
    case 8: return launch<8>(x, q, o, B, N, S, C, nsample, r2, st);
    default: return cudaErrorInvalidValue;
  }
}
