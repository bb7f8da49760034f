"""Scatter-mean upsample, the decoder's coarse -> fine transition op.

Counterpart of ``mpa_tpu/ops/scatter.py::scatter_mean_upsample`` and of
``mpa_tpu/ops/pallas/scatter_pallas.py::scatter_mean_upsample_pallas`` with
its custom VJP. Every coarse point ``s`` gives its feature to the K fine
points ``knn_idx[b, s, :]``; each fine point takes the mean of the features
of the coarse points that claimed it (a slot named twice by one coarse point
counts twice); unclaimed fine points stay zero.

On a CUDA tensor :func:`scatter_mean_upsample` is a
``torch.autograd.Function`` whose forward launches ``scatter_mean_kernel``
(``kernels/csrc/scatter_mean.cu``, in :func:`scatter_mean_form`'s form) and
keeps the per-slot count, and whose
backward is the VJP of ``scatter_pallas.py::_bwd``: the incoming gradient
divided by the count, gathered through ``gather_rows_kernel`` and summed over
K. On a CPU tensor it takes :func:`scatter_mean_plain`, which autograd
differentiates.

bf16 features (the mixed precision models') give a bf16 mean on both
devices: the sums, counts and divide are float32 and the mean is rounded
once (``mpa_tpu/ops/scatter.py:46-51``). The backward is ``mpa_tpu``'s:
the bf16 gradient divided by the float32 count is float32 (JAX's type
promotion in ``scatter_pallas.py::_bwd``), so its gather and its sum over K
run in float32, and the result is rounded to bf16 once.

The kernel's entry is the custom op ``mpa::scatter_mean``
(``ops/library.py``), which :func:`scatter_mean_cuda` calls;
:func:`scatter_mean_upsample` calls it directly where no gradient is
needed.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.ops.gather import (
    KERNEL_DTYPES, MAX_B, gather_cuda, index_form, partial_sums, stored,
)
from mpa_tpu_torch.utils.device import on_cuda


def scatter_mean_plain(
    features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the segment-sum form of ``mpa_tpu/ops/scatter.py`` with
    ``index_add_`` over (batch, fine-point) keys. Returns ``(mean [B, N, C]
    float32, count [B, N] float32)``; indices outside ``[0, num_fine)`` claim
    no slot. The mean of bf16 features is the float32 one rounded to bf16
    (``scatter_mean_kernel``'s contract)."""
    B, S, C = features.shape
    K = knn_idx.shape[-1]
    idx = knn_idx.long()
    keep = ((idx >= 0) & (idx < num_fine)).reshape(-1)
    offset = torch.arange(B, device=idx.device)[:, None, None] * num_fine
    seg = (idx + offset).reshape(-1)[keep]
    vals = features.float()[:, :, None, :].expand(B, S, K, C).reshape(-1, C)[keep]
    summed = torch.zeros((B * num_fine, C), dtype=torch.float32, device=features.device)
    summed = summed.index_add(0, seg, vals)
    count = torch.zeros((B * num_fine,), dtype=torch.float32, device=features.device)
    count.index_add_(0, seg, torch.ones_like(seg, dtype=torch.float32))
    out = summed / count.clamp_min(1.0)[:, None]
    return stored(out.reshape(B, num_fine, C), features), count.reshape(B, num_fine)


def check_args(features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int) -> None:
    if (features.dim() != 3 or knn_idx.dim() != 3
            or tuple(knn_idx.shape[:2]) != tuple(features.shape[:2])):
        raise ValueError(
            f"scatter_mean_upsample: features [B,S,C] and knn_idx [B,S,K] expected, got "
            f"{tuple(features.shape)}, {tuple(knn_idx.shape)}"
        )
    if knn_idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"scatter_mean_upsample: integer indices expected, got {knn_idx.dtype}")
    if num_fine < 0:
        raise ValueError(f"scatter_mean_upsample: num_fine={num_fine} < 0")


def scatter_mean_form(features: torch.Tensor, num_fine: int) -> Tuple[int, int]:
    """``scatter_mean_kernel``'s form for ``features [B,S,C]`` into
    ``num_fine`` slots, ``(slots, vec)``: ``ops/gather.py::index_form``'s
    (256 slots a block halved down to 32 while the launch has fewer than
    ``FILL_BLOCKS`` blocks; eight bf16 or four channels a lane where they
    divide ``C`` and ``features`` is aligned to them, else one). The
    kernel's entry refuses any other form."""
    return index_form(features, num_fine)


def check_cuda_args(name: str, features: torch.Tensor, knn_idx: torch.Tensor,
                    num_fine: int) -> None:
    """The scatter-mean kernels' arguments: features ``[B,S,C]`` f32 or bf16,
    knn_idx ``[B,S,K]`` int32, contiguous on one CUDA device, in the
    kernels' limits."""
    check_args(features, knn_idx, num_fine)
    for arg, t, dts in (("features", features, KERNEL_DTYPES),
                        ("knn_idx", knn_idx, (torch.int32,))):
        if not library.kernel_device(t) or t.dtype not in dts or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous "
                             f"{' or '.join(map(str, dts))} CUDA tensor")
    if features.device != knn_idx.device:
        raise ValueError(f"{name}: features and knn_idx on different devices")
    B, S, C = features.shape
    K = knn_idx.shape[2]
    if B > MAX_B or C < 1 or K < 1 or S * K >= 2 ** 31:
        raise ValueError(f"{name}: B <= {MAX_B}, C >= 1, K >= 1 and S*K < 2^31 "
                         f"expected, got B={B}, S={S}, K={K}, C={C}")


def scatter_mean_fake(name: str, features: torch.Tensor, knn_idx: torch.Tensor,
                      num_fine: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter-mean ops' fake: ``(mean [B,num_fine,C]`` of the features'
    type, ``count [B,num_fine]`` f32)."""
    check_cuda_args(name, features, knn_idx, num_fine)
    B, _, C = features.shape
    return (features.new_empty((B, num_fine, C)),
            features.new_empty((B, num_fine), dtype=torch.float32))


def _scatter_mean_impl(features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int):
    """``mpa::scatter_mean`` on the card: launch ``scatter_mean_kernel`` in
    :func:`scatter_mean_form`'s form."""
    check_cuda_args("scatter_mean_kernel", features, knn_idx, num_fine)
    B, S, C = features.shape
    K = knn_idx.shape[2]
    slots, vec = scatter_mean_form(features, num_fine)
    bf16 = features.dtype == torch.bfloat16
    out = torch.empty((B, num_fine, C), dtype=features.dtype, device=features.device)
    count = torch.empty((B, num_fine), dtype=torch.float32, device=features.device)
    part = partial_sums(out, S * K)
    lib = build.load()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_scatter_mean(features.data_ptr(), knn_idx.data_ptr(), out.data_ptr(),
                                 None if part is None else part.data_ptr(), count.data_ptr(),
                                 B, S, K, num_fine, C, slots, vec, int(bf16), stream),
            f"scatter_mean_kernel ({slots} slots a block, {vec} channels a lane)",
        )
    kernels.launched("scatter_mean_kernel",
                     {"features": features, "knn_idx": knn_idx, "num_fine": num_fine}, bf16=bf16)
    return out, count


scatter_mean_op = library.define(
    "scatter_mean(Tensor features, Tensor knn_idx, SymInt num_fine) -> (Tensor, Tensor)",
    _scatter_mean_impl, functools.partial(scatter_mean_fake, "scatter_mean_kernel"))


def scatter_mean_cuda(
    features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scatter_mean_kernel`` through ``mpa::scatter_mean``: features
    ``[B,S,C]`` f32 or bf16, knn_idx ``[B,S,K]`` int32 -> ``(mean
    [B,num_fine,C]`` of features' type``, count [B,num_fine]`` f32)."""
    library.check_device("scatter_mean_kernel", features, knn_idx)
    return scatter_mean_op(features, knn_idx, num_fine)


def scatter_mean_bwd_cuda(
    grad: torch.Tensor, knn_idx: torch.Tensor, count: torch.Tensor
) -> torch.Tensor:
    """The scatter-mean's VJP on CUDA tensors: ``df[s] = sum_k g[idx[s, k]] /
    max(count[idx[s, k]], 1)``, the rows picked by ``gather_rows_kernel``.
    grad ``[B,N,C]`` f32, knn_idx ``[B,S,K]`` int32 in ``[0, N)``, count
    ``[B,N]`` -> ``[B,S,C]`` f32. A bf16 ``grad`` divided by the f32 count
    is f32, as in ``mpa_tpu``."""
    B, S, K = knn_idx.shape
    g_norm = (grad / count.clamp_min(1.0)[..., None]).contiguous()
    picked = gather_cuda(g_norm, knn_idx.reshape(B, S * K))
    return picked.reshape(B, S, K, -1).sum(dim=2)


class _ScatterMean(torch.autograd.Function):
    """``scatter_mean_kernel`` forward; backward through
    ``gather_rows_kernel``. Saves the index and the count, not the features."""

    @staticmethod
    def forward(ctx, features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int):
        out, count = scatter_mean_cuda(features, knn_idx, num_fine)
        ctx.save_for_backward(knn_idx, count)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        knn_idx, count = ctx.saved_tensors
        return stored(scatter_mean_bwd_cuda(grad, knn_idx, count), grad), None, None


def scatter_mean_upsample(
    features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int
) -> torch.Tensor:
    """Scatter coarse features to fine slots and normalise by the count
    (differentiable in ``features``).

    Args:
      features: ``[B, S, C]`` coarse-point features.
      knn_idx: ``[B, S, K]`` indices of the K fine points each coarse point
        claims, values in ``[0, num_fine)``.
      num_fine: number of fine points N.

    Returns:
      ``[B, N, C]`` mean of the claiming coarse features per fine point;
      zeros for unclaimed slots.
    """
    check_args(features, knn_idx, num_fine)
    if on_cuda(features, "features"):
        rows = (features if features.dtype == torch.bfloat16 else features.float()).contiguous()
        idx = knn_idx.to(torch.int32).contiguous()
        if library.needs_grad(rows):
            return _ScatterMean.apply(rows, idx, num_fine).to(features.dtype)
        return scatter_mean_cuda(rows, idx, num_fine)[0].to(features.dtype)
    return scatter_mean_plain(features, knn_idx, num_fine)[0].to(features.dtype)
