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

}  // namespace mpa
