"""Morton (Z-order) spatial ordering for point arrays.

Counterpart of ``mpa_tpu/ops/morton.py``, the precondition of the window
modes (``ops/window.py``): sorted by Morton code, spatially near points sit
at nearby rows, so a query's k nearest neighbours fall inside a narrow index
band.

The codes are bit-equal to ``mpa_tpu``'s: the same float32 operations in the
same order, ``(xyz - lo) / span * 1023 + 0.5``, truncated to int32 and
clipped. The order is a stable sort, so points with equal codes (S3DIS
blocks are sampled with replacement, so duplicate points are the norm) keep
their input order, as ``jnp.argsort`` keeps it.
"""

from __future__ import annotations

import torch

_BITS = 10  # bits per axis; 3 * 10 = 30 bits fit an int32


def _spread_bits_3(x: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits between each of the low 10 bits of ``x`` (int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_code(points: torch.Tensor) -> torch.Tensor:
    """Morton codes of ``[..., N, 3+]`` coordinates -> int32 ``[..., N]``;
    each cloud is min-max normalised to the ``[0, 2^10)`` grid first."""
    xyz = points[..., :3].float()
    lo = torch.amin(xyz, dim=-2, keepdim=True)
    hi = torch.amax(xyz, dim=-2, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-12)
    q = ((xyz - lo) / span * (2 ** _BITS - 1) + 0.5).to(torch.int32)
    q = torch.clamp(q, 0, 2 ** _BITS - 1)
    return (_spread_bits_3(q[..., 0])
            | (_spread_bits_3(q[..., 1]) << 1)
            | (_spread_bits_3(q[..., 2]) << 2))


def morton_order(points: torch.Tensor) -> torch.Tensor:
    """Permutation sorting ``[B, N, 3+]`` points by Morton code -> ``[B, N]``
    int32, ascending, ties in input order."""
    return torch.argsort(morton_code(points), dim=-1, stable=True).to(torch.int32)


def morton_sort(points: torch.Tensor, *extras: torch.Tensor):
    """Sort ``points`` (and any ``extras`` that share its ``[B, N]`` axes) into
    Morton order. Returns ``(sorted_points, *sorted_extras, perm)`` with
    ``sorted[i] = original[perm[i]]``."""
    perm = morton_order(points)
    out = [_take_rows(points, perm)]
    out += [_take_rows(e, perm) for e in extras]
    return (*out, perm)


def _take_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[b, perm[b, i], ...]`` for ``x`` of shape ``[B, N]`` or ``[B, N, C]``."""
    idx = perm.long()
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)
