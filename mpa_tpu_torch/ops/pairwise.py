"""Pairwise squared distance, the root op under kNN, and the cosine Gram
matrix ``inner_correlation``.

Counterpart of ``mpa_tpu/ops/pairwise.py::square_distance``: the expanded
form ``|a|^2 + |b|^2 - 2 a.b^T`` in float32, clamped at 0. The clamp matters:
a point's distance to itself and to an exact duplicate both come out as 0 and
tie, and kNN then gives the tie to the lower index.

The dot products are accumulated channel by channel, in channel order, one
rounded multiply and one rounded add per channel (no fused multiply-add).
``kernels/csrc/knn.cu`` computes the same sums in the same order, so the
kernel and this plain version agree bit for bit and select the same
neighbours even where two distances differ only in their last bit.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_in_channel_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_c a[..., c] * b[..., c]`` accumulated in channel order."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 distance.

    Args:
      src: ``[..., N, C]`` query points/features.
      dst: ``[..., M, C]`` base points/features.

    Returns:
      ``[..., N, M]`` float32 squared distances, clamped at 0.
    """
    src = src.float()
    dst = dst.float()
    s2 = dot_in_channel_order(src, src)  # [..., N]
    d2 = dot_in_channel_order(dst, dst)  # [..., M]
    cross = dot_in_channel_order(src.unsqueeze(-2), dst.unsqueeze(-3))  # [..., N, M]
    out = (s2.unsqueeze(-1) + d2.unsqueeze(-2)) - 2.0 * cross
    return torch.clamp_min(out, 0.0)


def inner_correlation(z: torch.Tensor, index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cosine-similarity Gram matrix of a point or feature set
    (``mpa_tpu/ops/pairwise.py::inner_correlation``, which nothing calls).

    Args:
      z: ``[B, N, C]`` features.
      index: optional ``[B, S]`` or ``[B, S, K]`` rows gathered first
        (``index_points``: ``gather_rows_kernel`` on the card).

    Returns:
      ``[B, N, N]`` (``[B, S, S]``, ``[B, S, K, K]``) float32 cosines: each
      row normalised by its norm clamped at 1e-12 inside the square root
      (torch ``F.normalize``'s clamp, with a zero gradient on a zero row),
      then ``z_n @ z_n^T``.
    """
    if index is not None:
        from mpa_tpu_torch.ops.gather import index_points

        z = index_points(z, index)
    z = z.float()
    norm = torch.sqrt(torch.clamp_min(torch.sum(z * z, dim=-1, keepdim=True), 1e-24))
    z_n = z / norm
    return torch.matmul(z_n, z_n.transpose(-1, -2))
