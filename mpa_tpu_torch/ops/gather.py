"""Batched row gather and its gradient, the row scatter-add.

Counterpart of ``mpa_tpu/ops/gather.py::index_points`` (and of its
``resort_points``, a plain ``torch.gather`` here, as ``take_along_axis``
outside any Pallas kernel there) and of the custom VJP
of ``mpa_tpu/ops/pallas/gather_pallas.py::gather_neighbors``. On a CUDA
float32 tensor, :func:`index_points` is a ``torch.autograd.Function`` whose
forward launches ``gather_rows_kernel`` (``kernels/csrc/gather.cu``) and whose
backward launches ``scatter_add_rows_kernel``
(``kernels/csrc/scatter_add.cu``); on a CPU tensor it takes
:func:`gather_plain`, which autograd differentiates.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.utils.device import on_cuda


def gather_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: advanced indexing."""
    B = points.shape[0]
    batch = torch.arange(B, device=points.device).view((B,) + (1,) * (idx.dim() - 1))
    return points[batch, idx.long()]


def scatter_add_plain(grads: torch.Tensor, idx: torch.Tensor, num_points: int) -> torch.Tensor:
    """Plain version of the scatter-add: ``out[b, idx[b, e]] += grads[b, e]``
    into ``torch.zeros`` with ``index_add_``. grads ``[B, E, W]``, idx
    ``[B, E]`` -> ``[B, num_points, W]`` float32; targets outside
    ``[0, num_points)`` are dropped (``gather_pallas.py::scatter_add_rmw``)."""
    B, E, W = grads.shape
    idx = idx.long()
    keep = (idx >= 0) & (idx < num_points)
    offset = torch.arange(B, device=idx.device)[:, None] * num_points
    out = torch.zeros((B * num_points, W), dtype=torch.float32, device=grads.device)
    out.index_add_(0, (idx + offset)[keep], grads.float()[keep])
    return out.reshape(B, num_points, W)


def _check(points: torch.Tensor, idx: torch.Tensor) -> None:
    if points.dim() != 3 or idx.dim() < 2 or idx.shape[0] != points.shape[0]:
        raise ValueError(
            f"index_points: points [B,N,C] and idx [B,...] expected, got "
            f"{tuple(points.shape)}, {tuple(idx.shape)}"
        )
    if idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"index_points: integer indices expected, got {idx.dtype}")


def _check_cuda(name: str, tensors) -> None:
    device = tensors[0][1].device
    for arg, t, dt in tensors:
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dt} CUDA tensor")
        if t.device != device:
            raise ValueError(f"{name}: {tensors[0][0]} and {arg} on different devices")


def gather_cuda(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch ``gather_rows_kernel``: points ``[B,N,W]`` f32, idx ``[B,E]``
    int32 in ``[0, N)`` -> ``[B,E,W]``."""
    _check(points, idx)
    if idx.dim() != 2:
        raise ValueError("gather_rows_kernel: idx must be [B, E]")
    _check_cuda("gather_rows_kernel", (("points", points, torch.float32),
                                       ("idx", idx, torch.int32)))
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


def scatter_add_cuda(grads: torch.Tensor, idx: torch.Tensor, num_points: int) -> torch.Tensor:
    """Launch ``scatter_add_rows_kernel``: grads ``[B,E,W]`` f32, idx
    ``[B,E]`` int32 -> ``[B,num_points,W]`` f32 (out-of-range targets
    dropped)."""
    if grads.dim() != 3 or idx.dim() != 2 or tuple(idx.shape) != tuple(grads.shape[:2]):
        raise ValueError(
            f"scatter_add_rows_kernel: grads [B,E,W] and idx [B,E] expected, got "
            f"{tuple(grads.shape)}, {tuple(idx.shape)}"
        )
    if num_points < 0:
        raise ValueError(f"scatter_add_rows_kernel: num_points={num_points} < 0")
    _check_cuda("scatter_add_rows_kernel", (("grads", grads, torch.float32),
                                            ("idx", idx, torch.int32)))
    B, E, W = grads.shape
    out = torch.empty((B, num_points, W), dtype=torch.float32, device=grads.device)
    lib = build.load()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_scatter_add_rows(grads.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     B, num_points, E, W, stream),
            "scatter_add_rows_kernel",
        )
    kernels.launched("scatter_add_rows_kernel",
                     {"grads": grads, "idx": idx, "num_points": num_points})
    return out


class _GatherRows(torch.autograd.Function):
    """``gather_rows_kernel`` forward, ``scatter_add_rows_kernel`` backward
    (the gather's VJP, ``gather_pallas.py:316-332``). Saves only the index."""

    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.num_points = points.shape[1]
        return gather_cuda(points, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return scatter_add_cuda(grad.float().contiguous(), idx, ctx.num_points), None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points by per-batch indices (differentiable in ``points``).

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
        out = _GatherRows.apply(points.float().contiguous(), flat)
        return out.reshape(tuple(idx.shape) + (C,)).to(points.dtype)
    return gather_plain(points, idx)


def resort_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Reorder the group axis of ``[B, N, G, C]`` by a per-(B, N)
    permutation ``idx`` ``[B, N, G]`` (the umbrella's azimuth sort)."""
    index = idx.long()[..., None].expand(*idx.shape, points.shape[-1])
    return torch.gather(points, 2, index)
