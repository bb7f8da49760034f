"""The basic MLP unit of every Markov block: Linear + BatchNorm + LeakyReLU(0.2).

Counterpart of ``mpa_tpu/nn/linear.py::LinearUnit``. Submodule names follow
the flax module (``linear``, ``norm``) so a JAX checkpoint maps onto it key
for key (``utils/convert.py``).

This slice is inference: BatchNorm normalises with its running statistics.
Training mode raises, because flax keeps the biased batch variance in its
running statistics and torch the unbiased one; the training slice owns that
difference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over every non-channel axis of a channel-last tensor
    (``eps=1e-5``), eval mode only."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm training mode is not ported yet (flax's biased running "
                "variance); call .eval()"
            )
        flat = x.reshape(-1, x.shape[-1])
        y = F.batch_norm(flat, self.running_mean, self.running_var, self.weight, self.bias,
                         False, 0.0, self.eps)
        return y.reshape(x.shape)


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
        if mid_op is not None:
            raise NotImplementedError("LinearUnit mid_op arrives with part-seg")
        x = self.linear(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, negative_slope=0.2)
