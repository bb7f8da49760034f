"""Batched row gather.

Counterpart of ``mpa_tpu/ops/gather.py::index_points`` (forward only: the
gradient's scatter-add kernel belongs to the training slice). On a CUDA
float32 tensor it launches ``gather_rows_kernel``
(``kernels/csrc/gather.cu``); on a CPU tensor it takes :func:`gather_plain`.
"""

from __future__ import annotations

import torch

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.utils.device import on_cuda


def gather_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: advanced indexing."""
    B = points.shape[0]
    batch = torch.arange(B, device=points.device).view((B,) + (1,) * (idx.dim() - 1))
    return points[batch, idx.long()]


def _check(points: torch.Tensor, idx: torch.Tensor) -> None:
    if points.dim() != 3 or idx.dim() < 2 or idx.shape[0] != points.shape[0]:
        raise ValueError(
            f"index_points: points [B,N,C] and idx [B,...] expected, got "
            f"{tuple(points.shape)}, {tuple(idx.shape)}"
        )
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"index_points: integer indices expected, got {idx.dtype}")


def gather_cuda(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch ``gather_rows_kernel``: points ``[B,N,W]`` f32, idx ``[B,E]``
    int32 in ``[0, N)`` -> ``[B,E,W]``."""
    _check(points, idx)
    if idx.dim() != 2:
        raise ValueError("gather_rows_kernel: idx must be [B, E]")
    for name, t, dt in (("points", points, torch.float32), ("idx", idx, torch.int32)):
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"gather_rows_kernel: {name} must be a contiguous {dt} CUDA tensor")
    if points.device != idx.device:
        raise ValueError("gather_rows_kernel: points and idx on different devices")
    B, N, W = points.shape
    E = idx.shape[1]
    out = torch.empty((B, E, W), dtype=points.dtype, device=points.device)
    lib = build.load()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_gather_rows(points.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                B, N, E, W, stream),
            "gather_rows_kernel",
        )
    kernels.launched("gather_rows_kernel", {"points": points, "idx": idx})
    return out


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points by per-batch indices.

    Args:
      points: ``[B, N, C]``.
      idx: integer indices ``[B, *group_dims]`` with values in ``[0, N)``.

    Returns:
      ``[B, *group_dims, C]`` gathered rows.
    """
    _check(points, idx)
    if on_cuda(points, "points"):
        B, _, C = points.shape
        flat = idx.reshape(B, -1).to(torch.int32).contiguous()
        out = gather_cuda(points.float().contiguous(), flat)
        return out.reshape(tuple(idx.shape) + (C,)).to(points.dtype)
    return gather_plain(points, idx)
