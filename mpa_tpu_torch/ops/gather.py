"""Batched row gather and its gradient, the row scatter-add.

Counterpart of ``mpa_tpu/ops/gather.py::index_points`` (and of its
``resort_points``, a plain ``torch.gather`` here, as ``take_along_axis``
outside any Pallas kernel there) and of the custom VJP
of ``mpa_tpu/ops/pallas/gather_pallas.py::gather_neighbors``. On a CUDA
float32 tensor, :func:`index_points` is a ``torch.autograd.Function`` whose
forward launches ``gather_rows_kernel`` (``kernels/csrc/gather.cu``) and whose
backward launches ``scatter_add_rows_kernel``
(``kernels/csrc/scatter_add.cu``, in :func:`scatter_add_form`'s form); on a
CPU tensor it takes :func:`gather_plain`, which autograd differentiates.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.utils.device import on_cuda

MAX_B = 65535  # the inverse-index kernels' grids run the batch along y
# The inverse-index kernels (kernels/csrc/scatter_index.cuh: the scatter-add
# and both scatter-means) own at most 256 slots a block (one a thread in
# their scan); their form takes fewer, down to 32 (8 for the windowed one),
# until the launch has two blocks for each of the H100's 132 SMs, and down
# to 8 while half a block's slots still bring ROW_BYTES of rows to add
# (long, wide rows: many small blocks keep more loads in flight and even
# out the SMs' shares).
MAX_SLOTS, MIN_SLOTS, MIN_ROW_SLOTS = 256, 32, 8
FILL_BLOCKS = 2 * 132
ROW_BYTES = 64 * 1024


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


def index_form(rows: torch.Tensor, num_slots: int, claims: int = 0,
               min_slots: int = MIN_SLOTS) -> Tuple[int, int]:
    """The form of an inverse-index kernel for source rows ``rows [B,R,C]``
    into ``num_slots`` slots a cloud, with ``claims`` claims a cloud (0:
    none counted): ``(slots, vec)``. ``slots``: the slots a block owns (it
    reads its claim range once for them), 256 halved down to ``min_slots``
    while the launch has fewer than ``FILL_BLOCKS`` blocks, then down to 8
    while half of them bring ``ROW_BYTES`` of rows on average. ``vec``: the
    channels a lane adds, 4 (float4 loads and stores) where ``C % 4 == 0``
    and ``rows`` starts on a 16-byte boundary, else 1. The kernels' entries
    refuse any other form."""
    B, _, C = rows.shape
    slots = MAX_SLOTS
    while slots > min_slots and B * -(-num_slots // slots) < FILL_BLOCKS:
        slots //= 2
    while (slots > MIN_ROW_SLOTS and num_slots > 0
           and slots // 2 * claims * C * 4 >= ROW_BYTES * num_slots):
        slots //= 2
    vec = 4 if C % 4 == 0 and rows.data_ptr() % 16 == 0 else 1
    return slots, vec


def scatter_add_form(grads: torch.Tensor, num_points: int) -> Tuple[int, int]:
    """``scatter_add_rows_kernel``'s form for ``grads [B,E,W]`` into
    ``num_points`` rows: :func:`index_form`'s, with E claims a cloud, and two
    channels a lane (float2) where it gives one and W is even with
    ``grads`` 8-byte aligned (repsurf's 10 normal channels)."""
    slots, vec = index_form(grads, num_points, grads.shape[1])
    if vec == 1 and grads.shape[2] % 2 == 0 and grads.data_ptr() % 8 == 0:
        vec = 2
    return slots, vec


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
    """Launch ``scatter_add_rows_kernel`` in :func:`scatter_add_form`'s form:
    grads ``[B,E,W]`` f32, idx ``[B,E]`` int32 -> ``[B,num_points,W]`` f32
    (out-of-range targets dropped)."""
    name = "scatter_add_rows_kernel"
    if grads.dim() != 3 or idx.dim() != 2 or tuple(idx.shape) != tuple(grads.shape[:2]):
        raise ValueError(
            f"{name}: grads [B,E,W] and idx [B,E] expected, got "
            f"{tuple(grads.shape)}, {tuple(idx.shape)}"
        )
    if num_points < 0:
        raise ValueError(f"{name}: num_points={num_points} < 0")
    _check_cuda(name, (("grads", grads, torch.float32), ("idx", idx, torch.int32)))
    B, E, W = grads.shape
    if B > MAX_B or W < 1:
        raise ValueError(f"{name}: B <= {MAX_B} and W >= 1 expected, got B={B}, W={W}")
    slots, vec = scatter_add_form(grads, num_points)
    out = torch.empty((B, num_points, W), dtype=torch.float32, device=grads.device)
    lib = build.load()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_scatter_add_rows(grads.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     B, num_points, E, W, slots, vec, stream),
            f"{name} ({slots} slots a block, {vec} channels a lane)",
        )
    kernels.launched(name, {"grads": grads, "idx": idx, "num_points": num_points})
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
