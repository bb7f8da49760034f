"""The basic MLP unit of every Markov block: Linear + BatchNorm + LeakyReLU(0.2).

Counterpart of ``mpa_tpu/nn/linear.py::LinearUnit``. Submodule names follow
the flax module (``linear``, ``norm``) so a JAX checkpoint maps onto it key
for key (``utils/convert.py``).

BatchNorm follows flax (``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
use_fast_variance=False)``), not ``torch.nn.BatchNorm1d``, in train mode: it
normalises with the biased batch variance computed in two passes, and keeps
that biased variance, not the unbiased one, in its running statistics. Given
a process group (``mpa_tpu_torch/parallel``), its statistics are those of
the global batch, as ``mpa_tpu``'s are under a data-parallel ``jit``.
``norm="layer"`` is flax's ``nn.LayerNorm(epsilon=1e-5)`` (the reference's
``norm1``). ``act=False`` leaves the LeakyReLU out, as flax's ``act`` field
does (``mpa_tpu/nn/linear.py:30,60``); it has no parameters, so the
parameter names are the same either way.

``dtype`` (``torch.bfloat16``: the mixed precision models) is flax's
``nn.Dense(dtype=...)`` inside the unit: the parameters stay float32 and are
cast, with the input, to ``dtype``; the product and then the bias add are
taken in ``dtype``, each rounded (:func:`dense`); the norm and the
LeakyReLU run in float32 on the widened result (flax's float32 scale
promotes it), and the unit's output is cast to ``dtype``. Without a norm
the LeakyReLU runs in ``dtype``, as flax's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group``; its backward sums the incoming
    gradients over the ranks in turn (each rank's loss depends on every
    rank's share)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over every non-channel axis of a channel-last tensor
    (``eps=1e-5``) with flax's train-mode semantics.

    Train mode: ``mean`` and the biased ``var = mean((x - mean)^2)`` over all
    but the last axis; ``y = (x - mean) * (rsqrt(var + eps) * weight) +
    bias`` (flax's ``_normalize``); the running statistics become
    ``0.9 * running + (1 - 0.9) * batch`` with the biased ``var`` (flax
    ``momentum=0.9`` is torch ``momentum=0.1``). Eval mode normalises with the
    running statistics.

    With ``process_group`` set (``parallel.sync_batchnorm``), train mode
    reduces over the global batch of every rank of the group, in flax's two
    passes: ``mean`` is the all-reduced sum over the all-reduced row count,
    then ``var`` the all-reduced ``sum((x - mean)^2)`` over that count. The
    all-reduces carry the gradient (each rank's backward sums the others'),
    so the data-parallel step's averaged gradient is the global batch's.
    ``torch.nn.SyncBatchNorm`` would keep the unbiased running variance.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.process_group = None

    def _global_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(t, self.process_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if self.process_group is None:
                mean = torch.mean(x, dim=dims)
                centred = x - mean
                var = torch.mean(centred * centred, dim=dims)
            else:
                rows = x.new_full((1,), float(x.numel() // x.shape[-1]))
                total = self._global_sum(torch.cat([torch.sum(x, dim=dims), rows]))
                count = total[-1]
                mean = total[:-1] / count
                centred = x - mean
                var = self._global_sum(torch.sum(centred * centred, dim=dims)) / count
            y = centred * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
            keep = 1.0 - self.momentum  # flax's momentum
            with torch.no_grad():
                self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
            return y
        flat = x.reshape(-1, x.shape[-1])
        y = F.batch_norm(flat, self.running_mean, self.running_var, self.weight, self.bias,
                         False, 0.0, self.eps)
        return y.reshape(x.shape)


def seeded_dropout(x: torch.Tensor, p: float, training: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: in train mode keep each value with probability
    ``1 - p`` and scale the kept ones by ``1 / (1 - p)``, the mask drawn from
    ``generator`` (on ``x``'s device); the identity in eval mode or at
    ``p == 0``."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator on the model's device")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def check_compute_dtype(dtype) -> None:
    """A model's ``compute_dtype``: None (float32) or ``torch.bfloat16``."""
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {dtype!r}")


def dense(linear: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``linear`` applied as flax's ``nn.Dense(dtype=dtype)``: with ``dtype``
    None the float32 ``linear(x)``; else ``x @ W.T`` and then ``+ b`` in
    ``dtype``, the input, the weight and the bias cast to it, two roundings
    (``F.linear`` with its bias, or a fused epilogue, would round once)."""
    if dtype is None:
        return linear(x)
    y = torch.matmul(x.to(dtype), linear.weight.to(dtype).t())
    return y + linear.bias.to(dtype)


def dense_bias(linear: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """What ``dense`` gives for a zero input: the bias, in ``dtype``."""
    return linear.bias if dtype is None else linear.bias.to(dtype)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.2)``: in float32 ``F.leaky_relu``; in bf16
    ``where(x >= 0, x, bf16(0.2) * x)``, the slope a bf16 weak scalar as in
    JAX (``F.leaky_relu`` would multiply by the float32 0.2)."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, negative_slope=0.2)
    return torch.where(x >= 0, x, x * torch.tensor(0.2, dtype=x.dtype))


class LinearUnit(nn.Module):
    """Linear -> {BatchNorm | LayerNorm | none} -> LeakyReLU(0.2) (where
    ``act``); with ``dtype``, the mixed precision form of the module doc."""

    def __init__(self, in_features: int, features: int, norm: Optional[str] = "batch",
                 dtype: Optional[torch.dtype] = None, act: bool = True):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.linear = nn.Linear(in_features, features)
        if norm == "batch":
            self.norm = BatchNorm(features)
        elif norm == "layer":
            self.norm = nn.LayerNorm(features, eps=1e-5)
        elif norm is None:
            self.norm = None
        else:
            raise ValueError(f"unknown norm: {norm!r}")

    def forward(self, x: torch.Tensor, *, mid_op=None) -> torch.Tensor:
        """``mid_op``: an optional linear row-mixing map (the scatter-mean
        upsample) hoisted between the matmul and its bias,
        ``act(norm(mid_op(x @ W) + b))``: the matmul runs on the fewer input
        rows and the row mix at the narrower output width. As in ``mpa_tpu``
        the product is taken as ``linear(x) - b``, one rounding included, so
        rows that ``mid_op`` leaves zero come out as the bias. With ``dtype``
        every step of that form is taken in ``dtype``."""
        x = dense(self.linear, x, self.dtype)
        if mid_op is not None:
            bias = dense_bias(self.linear, self.dtype)
            x = mid_op(x - bias) + bias
        if self.norm is not None:
            x = self.norm(x if self.dtype is None else x.float())
        if self.act:
            x = leaky_relu(x)
        return x if self.dtype is None else x.to(self.dtype)
