"""The reference models' layers: a dense layer, BatchNorm, and the unit of
both (dense, BatchNorm, LeakyReLU(0.2)), with the parameter names that the
models' published checkpoints use (``linear``/``norm``, ``weight``/``bias``,
``running_mean``/``running_var``), and the table of every leaf that
``portbench/weights.py`` fills from the seed."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from portbench.reference import ops


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """``momentum`` is flax's: 0.9 moves the running statistics a tenth of
    the way to the batch's, 0 sets them to the batch's."""

    def __init__(self, features: int):
        super().__init__()
        self.momentum = 0.9
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                              self.training, momentum=self.momentum)


class LinearUnit(nn.Module):
    """``leaky_relu(batch_norm(linear(x)))``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.linear = Linear(in_features, features)
        self.norm = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.leaky_relu(self.norm(self.linear(x)))

    def upsampled(self, coarse: torch.Tensor, idx: torch.Tensor, num_fine: int) -> torch.Tensor:
        """The unit on ``coarse`` scatter-mean upsampled over ``idx`` (as
        ``ops.scatter_mean``), ordered as ``mpa_tpu`` orders it: the coarse
        rows projected, the mean of ``x W`` taken, then the bias; a fine row
        that no coarse row claims comes out as the bias."""
        b = self.linear.bias
        y = ops.scatter_mean(self.linear(coarse) - b, idx, num_fine) + b
        return ops.leaky_relu(self.norm(y))


# Leaf kinds of the weight table: a dense kernel (its fan-in decides its
# spread), a dense bias, a norm's scale and shift, its running statistics.
DENSE, BIAS, SCALE, SHIFT, MEAN, VAR = "dense", "bias", "scale", "shift", "mean", "var"


def weight_table(model: nn.Module) -> List[Tuple[str, Tuple[int, ...], str, Optional[int]]]:
    """``(name, shape, kind, fan_in)`` of every float leaf of ``model``
    (parameters and running statistics), in ``state_dict`` order."""
    kinds = {}
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(m, Linear):
            kinds[p + "weight"] = (DENSE, m.in_features)
            if m.bias is not None:
                kinds[p + "bias"] = (BIAS, None)
        elif isinstance(m, BatchNorm):
            kinds.update({p + "weight": (SCALE, None), p + "bias": (SHIFT, None),
                          p + "running_mean": (MEAN, None), p + "running_var": (VAR, None)})
    return [(name, tuple(t.shape), *kinds[name]) for name, t in model.state_dict().items()]


@torch.no_grad()
def calibrate(model: nn.Module, run) -> None:
    """Set every BatchNorm's running statistics to the batch statistics that
    ``run()`` (a train-mode forward of ``model``) gives it, so that the
    eval-mode model keeps its activations at the scale of its inputs, as a
    trained model's statistics do."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 0.0
    model.train()
    try:
        run()
    finally:
        for m in norms:
            m.momentum = 0.9
        model.eval()
