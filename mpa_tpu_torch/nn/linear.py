"""The basic MLP unit of every Markov block: Linear + BatchNorm + LeakyReLU(0.2).

Counterpart of ``mpa_tpu/nn/linear.py::LinearUnit``. Submodule names follow
the flax module (``linear``, ``norm``) so a JAX checkpoint maps onto it key
for key (``utils/convert.py``).

BatchNorm follows flax (``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
use_fast_variance=False)``), not ``torch.nn.BatchNorm1d``, in train mode: it
normalises with the biased batch variance taken from deviations about the
mean, and keeps that biased variance, not the unbiased one, in its running
statistics. Given a process group (``mpa_tpu_torch/parallel``), its
statistics are those of the global batch, as ``mpa_tpu``'s are under a
data-parallel ``jit``. ``BatchNorm.forward(x, act=True)`` applies the unit's
LeakyReLU too: in train mode without a process group the norm and its
activation are one call of ``ops/batch_norm.py::batch_norm_act``, the fused
kernels on a CUDA tensor and the plain arithmetic on a CPU one; eval mode
(``F.batch_norm``) and a set process group take the plain code with the
LeakyReLU after it.
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
the LeakyReLU runs in ``dtype``, as flax's does. A BatchNorm unit hands its
LeakyReLU to the norm (``act``); a LayerNorm unit applies it after.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.ops.batch_norm import batch_norm_act, leaky_relu, normalise_plain


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
    running statistics. ``act``: LeakyReLU(0.2) on the output, fused with
    the norm in train mode without a process group
    (``ops/batch_norm.py::batch_norm_act``).

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

    def forward(self, x: torch.Tensor, act: bool = False) -> torch.Tensor:
        stats = (self.running_mean, self.running_var)
        if self.training and self.process_group is None:
            return batch_norm_act(x, self.weight, self.bias, *stats, self.eps, self.momentum,
                                  act)
        if self.training:
            dims = tuple(range(x.dim() - 1))
            rows = x.new_full((1,), float(x.numel() // x.shape[-1]))
            total = self._global_sum(torch.cat([torch.sum(x, dim=dims), rows]))
            count = total[-1]
            mean = total[:-1] / count
            centred = x - mean
            var = self._global_sum(torch.sum(centred * centred, dim=dims)) / count
            y = normalise_plain(centred, mean, var, self.weight, self.bias, *stats, self.eps,
                                self.momentum)
        else:
            flat = x.reshape(-1, x.shape[-1])
            y = F.batch_norm(flat, *stats, self.weight, self.bias, False, 0.0,
                             self.eps).reshape(x.shape)
        # Where nothing differentiates it, the activation overwrites the
        # norm's own output: the caller still holds x, and a third full-size
        # tensor would raise a served request's peak memory.
        if act:
            y = leaky_relu(y, inplace=not (torch.is_grad_enabled() and y.requires_grad))
        return y


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
        if isinstance(self.norm, BatchNorm):
            x = self.norm(x if self.dtype is None else x.float(), act=self.act)
        else:
            if self.norm is not None:
                x = self.norm(x if self.dtype is None else x.float())
            if self.act:
                x = leaky_relu(x)
        return x if self.dtype is None else x.to(self.dtype)
