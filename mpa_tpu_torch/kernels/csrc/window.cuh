// The Morton-window contract shared by the windowed kernels (WindowSpec in
// ops/window.py, mpa_tpu/ops/pallas/window_attention.py): S queries in
// n_chunks chunks of sq rows, padded by sq/2 rows at each end, so there are
// n_chunks + 1 padded chunks; N base rows in n_chunks blocks of bn rows.
// Padded chunk c covers query rows [c*sq - sq/2, c*sq + sq/2) and sees the
// window of base rows [g*bn, g*bn + 2*bn), g = clamp(c - 1, 0, n_chunks - 2).
#pragma once

#include "common.cuh"

namespace mpa {

// Padded chunk c: its window's first base row and its real query rows
// [s_lo, s_hi).
struct WindowChunk {
  int win0, s_lo, s_hi;
  __device__ WindowChunk(int c, int S, int sq, int bn, int n_chunks) {
    win0 = min(max(c - 1, 0), n_chunks - 2) * bn;
    const int pad = sq / 2;
    s_lo = max(c * sq - pad, 0);
    s_hi = min(c * sq + sq - pad, S);
  }
};

// The query rows [lo, hi) whose windows can contain fine slot n: n lies in
// base block j = n / bn, which only the windows g = j - 1 and g = j contain;
// the padded chunks with those windows are consecutive (chunks 0 and 1 share
// window 0, the last two the last one), so their real rows are one range.
// Nondecreasing in n, so the rows that can claim slots [n0, n1] are
// [lo(n0), hi(n1)). ops/window.py::claim_rows is its Python twin.
__device__ __forceinline__ void claim_rows(int n, int S, int sq, int bn, int n_chunks, int& lo,
                                                int& hi) {
  const int j = n / bn;
  const int g_lo = max(j - 1, 0), g_hi = min(j, n_chunks - 2);
  const int c_lo = g_lo == 0 ? 0 : g_lo + 1;                    // first chunk with window g_lo
  const int c_hi = g_hi == n_chunks - 2 ? n_chunks : g_hi + 1;  // last chunk with window g_hi
  const int pad = sq / 2;
  lo = max(c_lo * sq - pad, 0);
  hi = min((c_hi + 1) * sq - pad, S);
}

}  // namespace mpa
