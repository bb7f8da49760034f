"""Seeded weight initialisation with flax's defaults.

``mpa_tpu``'s Dense layers start from flax's ``lecun_normal`` (a normal of
variance ``1/fan_in`` truncated at two standard deviations, rescaled to keep
that variance) with zero bias, where they have one; BatchNorm starts at
scale 1, bias 0, mean 0, variance 1. Torch cannot reproduce JAX's random streams, so the same seed
gives other numbers than in ``mpa_tpu``; tests that compare the two carry
the weights across instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every Linear and BatchNorm of ``module`` in place, in
    module order, from ``generator`` (a CPU generator, so the weights do not
    depend on the device the module later moves to)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module
