"""k-nearest-neighbour query.

Counterpart of ``mpa_tpu/ops/knn.py::knn``: exact squared distances in
float32, the k smallest per query in ascending order, ties to the lowest
index (``lax.top_k``'s order), and its ``knn_self`` and ``knn_point2``. On a
CUDA tensor :func:`knn` launches ``knn_kernel``
(``kernels/csrc/knn.cu``); on a CPU tensor it takes :func:`knn_plain`.
The kernel's entry is the custom op ``mpa::knn`` (``ops/library.py``),
which :func:`knn_cuda` calls; :func:`knn` calls it directly where no
gradient is needed, and through ``_KnnCuda`` where one is.

The distances are differentiable on both paths, as in ``mpa_tpu``. On CUDA
the kernel's values are kept, and the backward is that of
``sum_c (q - b[idx])^2``, the re-computation ``knn_pallas.py:147-165``
differentiates: ``2 (q - b[idx]) g`` into ``query`` and its negation
scatter-added into ``base`` (``gather_rows_kernel`` and
``scatter_add_rows_kernel``). The indices carry no gradient.

bf16 points or features (the mixed precision models' feature-space kNN) are
upcast to float32 before any distance, on both devices, as ``mpa_tpu``'s
``square_distance`` takes their products in float32
(``mpa_tpu/ops/pairwise.py:34-43``): ``knn_kernel`` stays float32, and the
distances are float32.

Each call of :func:`knn` counts one exact search in
``COUNTS["knn.exact"]`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.ops.gather import gather_cuda, scatter_add_cuda
from mpa_tpu_torch.ops.pairwise import square_distance
from mpa_tpu_torch.utils import profiling
from mpa_tpu_torch.utils.device import on_cuda

MAX_K = 64
MAX_C = 1024


def knn_plain(
    k: int, base: torch.Tensor, query: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: full distance matrix, then a stable ascending sort
    (``torch.topk`` makes no promise about the order of ties)."""
    d = square_distance(query, base)  # [B, S, N]
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return dist[..., :k].contiguous(), idx[..., :k].to(torch.int32).contiguous()


def _check(k: int, base: torch.Tensor, query: torch.Tensor) -> None:
    if base.dim() != 3 or query.dim() != 3:
        raise ValueError(f"knn: base/query must be [B,N,C]/[B,S,C], got {tuple(base.shape)}, {tuple(query.shape)}")
    if base.shape[0] != query.shape[0] or base.shape[2] != query.shape[2]:
        raise ValueError(f"knn: batch/channel mismatch {tuple(base.shape)} vs {tuple(query.shape)}")
    if not 1 <= k <= base.shape[1]:
        raise ValueError(f"knn: k={k} must be in [1, N={base.shape[1]}]")


def _check_kernel(k: int, base: torch.Tensor, query: torch.Tensor) -> None:
    """``knn_kernel``'s limits and arguments, read from shapes and types."""
    _check(k, base, query)
    C = base.shape[2]
    if k > MAX_K or C > MAX_C:
        raise ValueError(f"knn_kernel supports k <= {MAX_K} and C <= {MAX_C}, got k={k}, C={C}")
    for name, t in (("base", base), ("query", query)):
        if not library.kernel_device(t) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"knn_kernel: {name} must be a contiguous float32 CUDA tensor")
    if base.device != query.device:
        raise ValueError("knn_kernel: base and query on different devices")


def _knn_impl(k: int, base: torch.Tensor, query: torch.Tensor):
    """``mpa::knn`` on the card: launch ``knn_kernel``; a view off a 16-byte
    boundary is copied first (the kernel reads rows as float4s)."""
    _check_kernel(k, base, query)
    base, query = aligned(base), aligned(query)
    B, N, C = base.shape
    S = query.shape[1]
    dist = torch.empty((B, S, k), dtype=torch.float32, device=base.device)
    idx = torch.empty((B, S, k), dtype=torch.int32, device=base.device)
    norms = torch.empty((B, N), dtype=torch.float32, device=base.device)  # scratch: |b|^2
    lib = build.load()
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_knn(base.data_ptr(), query.data_ptr(), norms.data_ptr(), dist.data_ptr(),
                        idx.data_ptr(), B, N, S, C, k, stream),
            "knn_kernel",
        )
    kernels.launched("knn_kernel", {"k": k, "base": base, "query": query})
    return dist, idx


def _knn_fake(k: int, base: torch.Tensor, query: torch.Tensor):
    _check_kernel(k, base, query)
    shape = (base.shape[0], query.shape[1], k)
    return base.new_empty(shape), base.new_empty(shape, dtype=torch.int32)


knn_op = library.define("knn(int k, Tensor base, Tensor query) -> (Tensor, Tensor)",
                        _knn_impl, _knn_fake)


def knn_cuda(
    k: int, base: torch.Tensor, query: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``knn_kernel`` on contiguous float32 CUDA tensors, through ``mpa::knn``."""
    library.check_device("knn_kernel", base, query)
    return knn_op(k, base, query)


def knn_distance_grads(base, query, idx, g_dist, need_base: bool, need_query: bool):
    """The gradients of the selected distances ``sum_c (q - b[idx])^2`` on
    CUDA tensors: ``2 (q - b[idx]) g`` summed over the neighbours into
    ``query`` and its negation scatter-added into ``base``, through
    ``gather_rows_kernel`` and ``scatter_add_rows_kernel``. Returns
    ``(d_base or None, d_query or None)``."""
    B, N, C = base.shape
    S, k = idx.shape[1], idx.shape[2]
    flat = idx.reshape(B, S * k)
    diff = query[:, :, None, :] - gather_cuda(base, flat).reshape(B, S, k, C)
    d_query_rows = 2.0 * diff * g_dist[..., None]  # [B, S, k, C]
    d_base = d_query = None
    if need_base:
        d_base = scatter_add_cuda((-d_query_rows).reshape(B, S * k, C), flat, N)
    if need_query:
        d_query = d_query_rows.sum(dim=2)
    return d_base, d_query


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it starts on a 16-byte boundary, else a copy that
    does (inside an op's implementation: it reads ``data_ptr()``)."""
    return t.clone() if t.data_ptr() % 16 else t


class _KnnCuda(torch.autograd.Function):
    """``knn_kernel`` forward; the backward of the selected squared
    distances through the row gather and scatter-add kernels."""

    @staticmethod
    def forward(ctx, k: int, base: torch.Tensor, query: torch.Tensor):
        dist, idx = knn_cuda(k, base, query)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(base, query, idx)
        return dist, idx

    @staticmethod
    @once_differentiable
    def backward(ctx, g_dist: torch.Tensor, _g_idx):
        base, query, idx = ctx.saved_tensors
        d_base, d_query = knn_distance_grads(base, query, idx, g_dist, ctx.needs_input_grad[1],
                                             ctx.needs_input_grad[2])
        return None, d_base, d_query


def knn(
    k: int, base: torch.Tensor, query: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query point among the base points.

    Args:
      k: number of neighbours (``k <= 64`` on CUDA).
      base: ``[B, N, C]`` points/features searched over.
      query: ``[B, S, C]`` query points/features.

    Returns:
      ``(sqr_dists [B, S, k] float32, idx [B, S, k] int32)``, ascending.
    """
    profiling.COUNTS["knn.exact"] += 1
    if on_cuda(base, "base"):
        base, query = base.float().contiguous(), query.float().contiguous()
        if library.needs_grad(base, query):
            return _KnnCuda.apply(k, base, query)
        return knn_cuda(k, base, query)
    _check(k, base, query)
    return knn_plain(k, base, query)


def knn_self(k: int, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn` of a point set against itself: each point's own match,
    at distance 0, first (ties to the lowest index)."""
    return knn(k, points, points)


def knn_point2(k: int, points: torch.Tensor, generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-kNN that breaks coincident duplicates at random
    (``mpa_tpu/ops/knn.py::knn_point2``, which nothing calls, and takes no
    kernel there either): every zero distance but a point's own becomes
    ``10 + noise`` (standard normal noise from ``generator``, on the points'
    device), so a duplicate no longer ties its twin; the own match stays 0
    and first. Plain PyTorch on both devices. Returns
    ``(sqr_dists [B, N, k] float32, idx [B, N, k] int32)``, ascending."""
    _check(k, points, points)
    d = square_distance(points, points)  # [B, N, N]
    noise = torch.randn(d.shape, generator=generator, device=d.device)
    d = torch.where(d == 0.0, 10.0 + noise, d)
    diag = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    d = torch.where(diag, torch.zeros_like(d), d)
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return dist[..., :k].contiguous(), idx[..., :k].to(torch.int32).contiguous()
