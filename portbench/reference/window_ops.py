"""Plain PyTorch operations of the Morton-window neighbour modes, in float32,
written from their definitions. Nothing here comes from the program.

- Morton codes: each cloud's xyz min-max normalised per axis to a grid of
  ``2^10`` cells, ``q = trunc((x - lo) / max(hi - lo, 1e-12) * 1023 +
  0.5)`` clipped to ``[0, 1023]``, and the ten bits of each axis
  interleaved, x lowest (bit ``b`` of x at ``3b``, of y at ``3b + 1``, of z
  at ``3b + 2``); the order is a stable sort of the codes, so equal codes
  keep their input order.
- A window spec (:func:`window_spec`) for S query rows over N base rows,
  both in Morton order: the queries cut into ``n = S / sq`` chunks (``sq =
  min(128, S / 2)``), the base into as many blocks of ``bn = N / n`` rows;
  it exists only where ``sq`` divides S, there are two chunks or more,
  ``n`` divides N and ``sq`` and ``bn`` are multiples of 8. Query row ``s``
  sees the ``2 bn`` base rows from ``g bn``, ``g = clamp((s + sq / 2) // sq
  - 1, 0, n - 2)``: its window is centred on its chunk, shifted half a
  chunk.
- The windowed kNN: the k nearest base rows of each query inside its
  window, by the squared distance ``(|q|^2 + |b|^2) - 2 q.b`` (each dot
  product summed channel by channel in channel order, not clamped), ties to
  the lowest row (a stable sort). A scale pair without a spec searches all
  N rows (``ops.knn``), as the mode defines it.
- Banded FPS: the Morton-ordered cloud cut into G contiguous bands, G the
  largest power of two with every band at least ``min_band`` rows and
  ``min_samples`` samples (both dividing evenly), FPS from each band's
  first row (``ops.farthest_point_sample``), the samples as cloud rows,
  sorted ascending; windowed without banding, FPS over the whole cloud,
  sorted.
- The transition attention and the scatter-mean over a windowed index are
  the exact ones over that index: the window only constrains which rows
  the index names (``in_window`` checks it).

Departures: none in what is computed. The search is laid out in blocks of
``sq / 2`` query rows, which share a window, so that the distances of a
block are one batched product; each distance is still the per-row formula
above.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from portbench.reference import ops

BITS = 10


def morton_codes(xyz: torch.Tensor) -> torch.Tensor:
    """``[B, N, 3]`` -> int64 ``[B, N]`` Morton codes."""
    x = xyz.float()
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-12)
    q = ((x - lo) / span * float(2 ** BITS - 1) + 0.5).to(torch.int64)
    q = torch.clamp(q, 0, 2 ** BITS - 1)
    code = torch.zeros(q.shape[:2], dtype=torch.int64, device=q.device)
    for b in range(BITS):
        for axis in range(3):
            code |= ((q[..., axis] >> b) & 1) << (3 * b + axis)
    return code


def morton_order(xyz: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` int64: the rows of each cloud by ascending Morton code,
    equal codes in input order."""
    return torch.sort(morton_codes(xyz), dim=1, stable=True)[1]


@dataclasses.dataclass(frozen=True)
class Spec:
    S: int
    N: int
    sq: int
    bn: int
    n: int

    @property
    def window(self) -> int:
        return 2 * self.bn

    def starts(self, device=None) -> torch.Tensor:
        """``[S]`` int64: the first base row of each query row's window."""
        s = torch.arange(self.S, device=device)
        return torch.clamp((s + self.sq // 2) // self.sq - 1, 0, self.n - 2) * self.bn


def window_spec(S: int, N: int, sq: int = 128) -> Optional[Spec]:
    """The spec of S Morton-ordered queries over N base rows, or None where
    the pair admits none."""
    sq = min(sq, S // 2)
    if sq <= 0 or S % sq or S // sq < 2 or N % (S // sq):
        return None
    n = S // sq
    bn = N // n
    if bn % 8 or sq % 8:
        return None
    return Spec(S, N, sq, bn, n)


def in_window(idx: torch.Tensor, spec: Spec) -> bool:
    """Whether every ``idx[b, s, :]`` names a row of row s's window."""
    w0 = spec.starts(idx.device)[None, :, None]
    return bool(((idx >= w0) & (idx < w0 + spec.window)).all())


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_c a_c b_c`` over the last axis, added in channel order."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


@torch.no_grad()
def windowed_knn(k: int, base: torch.Tensor, query: torch.Tensor, spec: Spec) -> torch.Tensor:
    """``[B, S, k]`` int64: the k nearest rows of each query inside its
    window, nearest first, ties to the lowest row."""
    B, N, C = base.shape
    half = spec.sq // 2
    H = spec.S // half  # blocks of ``half`` rows; a block lies in one chunk
    w0 = spec.starts(base.device)[::half]  # [H]: each block's window start
    rows = w0[:, None] + torch.arange(spec.window, device=base.device)  # [H, 2bn]
    q = query.float().reshape(B, H, half, C)
    cand = base.float()[:, rows]  # [B, H, 2bn, C]
    q2 = _dot(q, q)[..., :, None]
    b2 = _dot(cand, cand)[..., None, :]
    cross = _dot(q[..., :, None, :], cand[..., None, :, :])  # [B, H, half, 2bn]
    d = (q2 + b2) - 2.0 * cross
    local = torch.sort(d, dim=-1, stable=True)[1][..., :k]
    return (local + w0[None, :, None, None]).reshape(B, spec.S, k)


def search(k: int, base: torch.Tensor, query: torch.Tensor, windowed: bool) -> torch.Tensor:
    """``[B, S, k]``: the windowed kNN where ``windowed`` and the pair admits
    a spec, the exact kNN otherwise."""
    spec = window_spec(query.shape[1], base.shape[1]) if windowed else None
    if spec is None:
        return ops.knn(k, base, query)
    return windowed_knn(k, base, query, spec)


def fps_bands(N: int, npoint: int, min_band: int, min_samples: int) -> int:
    g = 1
    while (N % (2 * g) == 0 and npoint % (2 * g) == 0 and N // (2 * g) >= min_band
           and npoint // (2 * g) >= min_samples):
        g *= 2
    return g


@torch.no_grad()
def banded_fps(points: torch.Tensor, npoint: int, bands: int) -> torch.Tensor:
    """``[B, npoint]`` int64 rows of ``points``: FPS inside each of ``bands``
    contiguous bands from its first row, ``npoint / bands`` a band, sorted
    ascending."""
    B, N, C = points.shape
    nb = N // bands
    local = ops.farthest_point_sample(points.reshape(B * bands, nb, C), npoint // bands)
    offset = torch.arange(bands, device=points.device)[None, :, None] * nb
    rows = local.reshape(B, bands, npoint // bands) + offset
    return torch.sort(rows.reshape(B, npoint), dim=1)[0]
