"""Batched row gather and its gradient, the row scatter-add.

Counterpart of ``mpa_tpu/ops/gather.py::index_points`` (and of its
``resort_points``, a plain ``torch.gather`` here, as ``take_along_axis``
outside any Pallas kernel there) and of the custom VJP
of ``mpa_tpu/ops/pallas/gather_pallas.py::gather_neighbors``. On a CUDA
float32 or bf16 tensor, :func:`index_points` is a ``torch.autograd.Function``
whose forward launches ``gather_rows_kernel`` (``kernels/csrc/gather.cu``, in
:func:`gather_form`'s form) and whose
backward launches ``scatter_add_rows_kernel``
(``kernels/csrc/scatter_add.cu``, in :func:`scatter_add_form`'s form); on a
CPU tensor it takes :func:`gather_plain`, which autograd differentiates.
:func:`mod_index` is ``mpa_tpu``'s row scatter-replace.

bf16 rows (the mixed precision models') stay bf16 on both devices: the
gather copies them as they are, and the gradient's scatter-add sums bf16
rows in float32 and rounds each sum to bf16 once, as ``mpa_tpu``'s
``scatter_add_rmw`` and the cast of the gather's VJP do
(``gather_pallas.py:202,332``); on the CPU a ``torch.autograd.Function``
gives :func:`gather_plain` that backward (autograd's own would add in bf16).

The kernels' entries are the custom ops ``mpa::gather`` and
``mpa::scatter_add`` (``ops/library.py``), which :func:`gather_cuda` and
:func:`scatter_add_cuda` call; :func:`index_points` calls the gather
directly where no gradient is needed.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
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
# gather_rows_kernel: a thread copies one column of the output, two where
# the launch would have MANY_BLOCKS blocks of GATHER_THREADS or more at one
# (four waves of eight blocks on each of the H100's 132 SMs): long launches
# gain from loads in flight, short ones from threads.
MANY_BLOCKS, GATHER_THREADS = 32 * 132, 256
# Indices an inverse-index block reads in one pass (scatter_index.cuh
# kMaxTile); a bf16 launch with more claims than that keeps the sums of its
# passes before the last in an f32 scratch.
MAX_TILE = 4096
# The storage types the eight kernels of the mixed precision path take.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def gather_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: advanced indexing."""
    B = points.shape[0]
    batch = torch.arange(B, device=points.device).view((B,) + (1,) * (idx.dim() - 1))
    return points[batch, idx.long()]


def stored(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A float32 result ``t`` in ``like``'s storage: rounded once to bf16
    where ``like`` is bf16, else as it is."""
    return t.to(torch.bfloat16) if like.dtype == torch.bfloat16 else t


def scatter_add_plain(grads: torch.Tensor, idx: torch.Tensor, num_points: int) -> torch.Tensor:
    """Plain version of the scatter-add: ``out[b, idx[b, e]] += grads[b, e]``
    into ``torch.zeros`` with ``index_add_``. grads ``[B, E, W]``, idx
    ``[B, E]`` -> ``[B, num_points, W]`` float32, or bf16 for bf16 grads (the
    float32 sums rounded once); targets outside ``[0, num_points)`` are
    dropped (``gather_pallas.py::scatter_add_rmw``)."""
    B, E, W = grads.shape
    idx = idx.long()
    keep = (idx >= 0) & (idx < num_points)
    offset = torch.arange(B, device=idx.device)[:, None] * num_points
    out = torch.zeros((B * num_points, W), dtype=torch.float32, device=grads.device)
    out.index_add_(0, (idx + offset)[keep], grads.float()[keep])
    return stored(out.reshape(B, num_points, W), grads)


def index_form(rows: torch.Tensor, num_slots: int, claims: int = 0,
               min_slots: int = MIN_SLOTS) -> Tuple[int, int]:
    """The form of an inverse-index kernel for source rows ``rows [B,R,C]``
    into ``num_slots`` slots a cloud, with ``claims`` claims a cloud (0:
    none counted): ``(slots, vec)``. ``slots``: the slots a block owns (it
    reads its claim range once for them), 256 halved down to ``min_slots``
    while the launch has fewer than ``FILL_BLOCKS`` blocks, then down to 8
    while half of them bring ``ROW_BYTES`` of rows on average. ``vec``: the
    channels a lane adds, the most of 16 bytes' worth (float32: 4, float4
    loads and stores; bf16: 8) and 4 (bf16: 8-byte loads) that divides C
    with ``rows`` starting on a boundary of that many values, else 1. The
    kernels' entries refuse any other form."""
    B, _, C = rows.shape
    es = rows.element_size()
    slots = MAX_SLOTS
    while slots > min_slots and B * -(-num_slots // slots) < FILL_BLOCKS:
        slots //= 2
    while (slots > MIN_ROW_SLOTS and num_slots > 0
           and slots // 2 * claims * C * es >= ROW_BYTES * num_slots):
        slots //= 2
    vec = next((v for v in (16 // es, 4) if C % v == 0 and rows.data_ptr() % (v * es) == 0), 1)
    return slots, vec


def gather_form(points: torch.Tensor, rows: int) -> Tuple[int, int]:
    """``gather_rows_kernel``'s form for ``rows`` output rows (B * E) of
    ``points [B,N,W]``: ``(vec, elems)``. ``vec``: the values a column
    moves at once, the most of 16, 8 and 4 bytes' worth (float32: 4, 2 or
    1; bf16: 8, 4 or 2, then 1) that divides W with ``points`` starting on a
    boundary of that many bytes (the output is a fresh allocation, always
    aligned). ``elems``: the columns a thread copies, 2 where one a thread
    takes ``MANY_BLOCKS`` blocks or more, else 1. The kernel's entry refuses
    any other form."""
    W = points.shape[2]
    es = points.element_size()
    ptr = points.data_ptr()
    vec = next((v for v in (16 // es, 8 // es, 4 // es)
                if W % v == 0 and ptr % (v * es) == 0), 1)
    blocks = -(-rows * (W // vec) // GATHER_THREADS)
    return vec, 2 if blocks >= MANY_BLOCKS else 1


def scatter_add_form(grads: torch.Tensor, num_points: int) -> Tuple[int, int]:
    """``scatter_add_rows_kernel``'s form for ``grads [B,E,W]`` into
    ``num_points`` rows: :func:`index_form`'s, with E claims a cloud, and two
    channels a lane (float2) where it gives one and W is even with
    ``grads`` aligned to two values (repsurf's 10 normal channels)."""
    slots, vec = index_form(grads, num_points, grads.shape[1])
    if vec == 1 and grads.shape[2] % 2 == 0 and grads.data_ptr() % (2 * grads.element_size()) == 0:
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
    """Each ``(arg, tensor, dtypes)`` a contiguous CUDA tensor of one of
    ``dtypes`` (a dtype or a tuple), all on one device."""
    device = tensors[0][1].device
    for arg, t, dt in tensors:
        dts = dt if isinstance(dt, tuple) else (dt,)
        if not library.kernel_device(t) or t.dtype not in dts or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous "
                             f"{' or '.join(map(str, dts))} CUDA tensor")
        if t.device != device:
            raise ValueError(f"{name}: {tensors[0][0]} and {arg} on different devices")


def _check_gather(points: torch.Tensor, idx: torch.Tensor) -> None:
    _check(points, idx)
    if idx.dim() != 2:
        raise ValueError("gather_rows_kernel: idx must be [B, E]")
    _check_cuda("gather_rows_kernel", (("points", points, KERNEL_DTYPES),
                                       ("idx", idx, torch.int32)))
    B, N, W = points.shape
    E = idx.shape[1]
    if B * N >= 2**31 or B * E * W >= 2**31:
        raise ValueError(f"gather_rows_kernel: B * N and B * E * W below 2^31 expected, got "
                         f"B={B}, N={N}, E={E}, W={W}")


def _gather_impl(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mpa::gather`` on the card: launch ``gather_rows_kernel`` in
    :func:`gather_form`'s form."""
    _check_gather(points, idx)
    B, N, W = points.shape
    E = idx.shape[1]
    vec, elems = gather_form(points, B * E)
    out = torch.empty((B, E, W), dtype=points.dtype, device=points.device)
    lib = build.load()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_gather_rows(points.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                B, N, E, W, vec, elems, points.element_size(), stream),
            f"gather_rows_kernel ({vec} values a column, {elems} columns a thread)",
        )
    kernels.launched("gather_rows_kernel", {"points": points, "idx": idx},
                     bf16=points.dtype == torch.bfloat16)
    return out


def _gather_fake(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_gather(points, idx)
    return points.new_empty((points.shape[0], idx.shape[1], points.shape[2]))


gather_op = library.define("gather(Tensor points, Tensor idx) -> Tensor", _gather_impl,
                           _gather_fake)


def gather_cuda(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``gather_rows_kernel`` through ``mpa::gather``: points ``[B,N,W]`` f32
    or bf16, idx ``[B,E]`` int32 in ``[0, N)`` -> ``[B,E,W]`` of points'
    type."""
    library.check_device("gather_rows_kernel", points, idx)
    return gather_op(points, idx)


def _check_scatter_add(grads: torch.Tensor, idx: torch.Tensor, num_points: int) -> None:
    name = "scatter_add_rows_kernel"
    if grads.dim() != 3 or idx.dim() != 2 or tuple(idx.shape) != tuple(grads.shape[:2]):
        raise ValueError(
            f"{name}: grads [B,E,W] and idx [B,E] expected, got "
            f"{tuple(grads.shape)}, {tuple(idx.shape)}"
        )
    if num_points < 0:
        raise ValueError(f"{name}: num_points={num_points} < 0")
    _check_cuda(name, (("grads", grads, KERNEL_DTYPES), ("idx", idx, torch.int32)))
    B, _, W = grads.shape
    if B > MAX_B or W < 1:
        raise ValueError(f"{name}: B <= {MAX_B} and W >= 1 expected, got B={B}, W={W}")


def _scatter_add_impl(grads: torch.Tensor, idx: torch.Tensor, num_points: int) -> torch.Tensor:
    """``mpa::scatter_add`` on the card: launch ``scatter_add_rows_kernel`` in
    :func:`scatter_add_form`'s form."""
    name = "scatter_add_rows_kernel"
    _check_scatter_add(grads, idx, num_points)
    B, E, W = grads.shape
    slots, vec = scatter_add_form(grads, num_points)
    bf16 = grads.dtype == torch.bfloat16
    out = torch.empty((B, num_points, W), dtype=grads.dtype, device=grads.device)
    part = partial_sums(out, E)
    lib = build.load()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_scatter_add_rows(grads.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                     None if part is None else part.data_ptr(),
                                     B, num_points, E, W, slots, vec, int(bf16), stream),
            f"{name} ({slots} slots a block, {vec} channels a lane)",
        )
    kernels.launched(name, {"grads": grads, "idx": idx, "num_points": num_points}, bf16=bf16)
    return out


def _scatter_add_fake(grads: torch.Tensor, idx: torch.Tensor, num_points: int) -> torch.Tensor:
    _check_scatter_add(grads, idx, num_points)
    return grads.new_empty((grads.shape[0], num_points, grads.shape[2]))


scatter_add_op = library.define(
    "scatter_add(Tensor grads, Tensor idx, SymInt num_points) -> Tensor", _scatter_add_impl,
    _scatter_add_fake)


def scatter_add_cuda(grads: torch.Tensor, idx: torch.Tensor, num_points: int) -> torch.Tensor:
    """``scatter_add_rows_kernel`` through ``mpa::scatter_add``: grads
    ``[B,E,W]`` f32 or bf16, idx ``[B,E]`` int32 -> ``[B,num_points,W]`` of
    grads' type (out-of-range targets dropped; bf16: float32 sums, each
    rounded once)."""
    library.check_device("scatter_add_rows_kernel", grads, idx)
    return scatter_add_op(grads, idx, num_points)


def partial_sums(out: torch.Tensor, claims: int):
    """The f32 scratch of an inverse-index kernel with bf16 slots ``out``
    and more than ``MAX_TILE`` claims a block (the sums of its passes before
    the last), else None."""
    if out.dtype != torch.bfloat16 or claims <= MAX_TILE:
        return None
    return torch.empty(out.shape, dtype=torch.float32, device=out.device)


class _GatherRows(torch.autograd.Function):
    """``gather_rows_kernel`` forward, ``scatter_add_rows_kernel`` backward
    (the gather's VJP, ``gather_pallas.py:316-332``), both in the rows'
    storage type. Saves only the index."""

    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.num_points = points.shape[1]
        return gather_cuda(points, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return scatter_add_cuda(grad.contiguous(), idx, ctx.num_points), None


class _GatherPlainBf16(torch.autograd.Function):
    """:func:`gather_plain` of bf16 rows on the CPU, its backward
    :func:`scatter_add_plain` (float32 sums, each rounded once); ``idx`` is
    ``[B, E]``."""

    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.num_points = points.shape[1]
        return gather_plain(points, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return scatter_add_plain(grad, idx, ctx.num_points), None


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather points by per-batch indices (differentiable in ``points``).

    Args:
      points: ``[B, N, C]``.
      idx: integer indices ``[B, *group_dims]`` with values in ``[0, N)``.

    Returns:
      ``[B, *group_dims, C]`` gathered rows.
    """
    _check(points, idx)
    B, _, C = points.shape
    if on_cuda(points, "points"):
        flat = idx.reshape(B, -1).to(torch.int32).contiguous()
        rows = points if points.dtype == torch.bfloat16 else points.float()
        rows = rows.contiguous()
        if library.needs_grad(rows):
            out = _GatherRows.apply(rows, flat)
        else:
            out = gather_cuda(rows, flat)
        return out.reshape(tuple(idx.shape) + (C,)).to(points.dtype)
    if points.dtype == torch.bfloat16:
        out = _GatherPlainBf16.apply(points, idx.reshape(B, -1))
        return out.reshape(tuple(idx.shape) + (C,))
    return gather_plain(points, idx)


def mod_index(base: torch.Tensor, mod_idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Rows of ``base [B, N, D]`` at per-cloud indices ``mod_idx [B, M]``
    replaced by ``values [B, M, D]``, in a copy (``mpa_tpu``'s
    ``mod_index``, which nothing calls; an indexed assignment there too,
    outside any kernel). Where ``mod_idx`` names a row twice, which of its
    values lands is unspecified, as in ``mpa_tpu`` (a CUDA write is not
    ordered)."""
    if base.dim() != 3 or tuple(mod_idx.shape) != tuple(values.shape[:2]) or (
            mod_idx.shape[0] != base.shape[0]):
        raise ValueError(f"mod_index: base [B,N,D], mod_idx [B,M], values [B,M,D] expected, got "
                         f"{tuple(base.shape)}, {tuple(mod_idx.shape)}, {tuple(values.shape)}")
    out = base.clone()
    batch = torch.arange(base.shape[0], device=base.device)[:, None]
    out[batch, mod_idx.long()] = values.to(base.dtype)
    return out


def resort_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Reorder the group axis of ``[B, N, G, C]`` by a per-(B, N)
    permutation ``idx`` ``[B, N, G]`` (the umbrella's azimuth sort)."""
    index = idx.long()[..., None].expand(*idx.shape, points.shape[-1])
    return torch.gather(points, 2, index)
