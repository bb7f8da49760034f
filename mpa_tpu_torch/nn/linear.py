"""The basic MLP unit of every Markov block: Linear + BatchNorm + LeakyReLU(0.2).

Counterpart of ``mpa_tpu/nn/linear.py::LinearUnit``. Submodule names follow
the flax module (``linear``, ``norm``) so a JAX checkpoint maps onto it key
for key (``utils/convert.py``).

BatchNorm follows flax (``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
use_fast_variance=False)``), not ``torch.nn.BatchNorm1d``, in train mode: it
normalises with the biased batch variance computed in two passes, and keeps
that biased variance, not the unbiased one, in its running statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over every non-channel axis of a channel-last tensor
    (``eps=1e-5``) with flax's train-mode semantics.

    Train mode: ``mean`` and the biased ``var = mean((x - mean)^2)`` over all
    but the last axis; ``y = (x - mean) * (rsqrt(var + eps) * weight) +
    bias`` (flax's ``_normalize``); the running statistics become
    ``0.9 * running + (1 - 0.9) * batch`` with the biased ``var`` (flax
    ``momentum=0.9`` is torch ``momentum=0.1``). Eval mode normalises with the
    running statistics.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=dims)
            centred = x - mean
            var = torch.mean(centred * centred, dim=dims)
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


class LinearUnit(nn.Module):
    """Linear -> {BatchNorm | none} -> LeakyReLU(0.2)."""

    def __init__(self, in_features: int, features: int, norm: Optional[str] = "batch"):
        super().__init__()
        self.linear = nn.Linear(in_features, features)
        if norm == "batch":
            self.norm = BatchNorm(features)
        elif norm is None:
            self.norm = None
        else:
            raise NotImplementedError(f"LinearUnit norm={norm!r} is not ported yet")

    def forward(self, x: torch.Tensor, *, mid_op=None) -> torch.Tensor:
        """``mid_op``: an optional linear row-mixing map (the scatter-mean
        upsample) hoisted between the matmul and its bias,
        ``act(norm(mid_op(x @ W) + b))``: the matmul runs on the fewer input
        rows and the row mix at the narrower output width. As in ``mpa_tpu``
        the product is taken as ``linear(x) - b``, one rounding included, so
        rows that ``mid_op`` leaves zero come out as the bias."""
        x = self.linear(x)
        if mid_op is not None:
            x = mid_op(x - self.linear.bias) + self.linear.bias
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, negative_slope=0.2)
