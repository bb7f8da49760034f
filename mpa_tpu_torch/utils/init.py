"""Seeding and weight initialisation (counterpart of ``mpa_tpu/utils/init.py``).

``mpa_tpu``'s Dense layers start from flax's ``lecun_normal`` (a normal of
variance ``1/fan_in`` truncated at two standard deviations, rescaled to keep
that variance) with zero bias, where they have one; BatchNorm starts at
scale 1, bias 0, mean 0, variance 1; a raw parameter (the extras') starts
from its own initialiser there. Torch cannot reproduce JAX's random streams, so the same seed
gives other numbers than in ``mpa_tpu``; tests that compare the two carry
the weights across instead.

:func:`apply_weight_init` is ``--init``'s re-initialisation (the
reference's ``model.apply(weight_init)``): every Dense weight drawn anew
(xavier: flax's ``glorot_normal``, kaiming: its ``he_normal``, both
normals truncated at two standard deviations and rescaled to the variance
``2 / (fan_in + fan_out)`` or ``2 / fan_in``; zero: the ZerO init of
:func:`zero_init_dense`, 2-D weights only), its bias 0, every norm scale 1
and norm bias 0; running statistics stay. ZerO is deterministic, so it
equals ``mpa_tpu``'s bit for bit; xavier and kaiming draw other values from
the same seed.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every Linear and BatchNorm of ``module`` in place, in
    module order, from ``generator`` (a CPU generator, so the weights do not
    depend on the device the module later moves to), and every raw
    parameter through its module's ``reset_flax_parameters(generator)``
    (``mpa_tpu``'s initialiser of that parameter)."""
    for m in module.modules():
        if hasattr(m, "reset_flax_parameters"):
            m.reset_flax_parameters(generator)
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


def set_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's legacy and torch's global generators and return
    a CPU ``torch.Generator`` seeded with ``seed`` (``mpa_tpu`` returns its
    root key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def zero_init_dense(out_features: int, in_features: int) -> torch.Tensor:
    """The ZerO init (Zhao et al.) of a torch Linear weight ``[out, in]``:
    the identity ``eye(out, in)`` when ``out <= in``, else ``eye(out, p) @
    H_p / 2^(log2(p) / 2) @ eye(p, in)`` with ``H_p`` the Hadamard matrix of
    the next power of two ``p >= out``; computed in float64 and rounded to
    float32, as ``mpa_tpu`` computes the transpose."""
    if out_features <= in_features:
        w = np.eye(out_features, in_features)
    else:
        clog = int(np.ceil(np.log2(out_features)))
        p = 2 ** clog
        h = _hadamard(p) / (2 ** (clog / 2))
        w = np.eye(out_features, p) @ h @ np.eye(p, in_features)
    return torch.from_numpy(w.astype(np.float32))


INIT_TYPES = ("xavier", "kaiming", "zero")


@torch.no_grad()
def apply_weight_init(module: nn.Module, init_type: str, generator: torch.Generator
                      ) -> nn.Module:
    """Re-initialise ``module`` in place as ``--init`` says (module doc):
    ``init_type`` is ``'xavier'``, ``'kaiming'`` or ``'zero'`` (any case,
    so ``'ZerO'`` too); the draws come from ``generator`` (a CPU one), one
    weight after another in module order. Raises ValueError for another
    name."""
    kind = init_type.lower()
    if kind not in INIT_TYPES:
        raise ValueError(f"no such init type: {init_type}")
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            if kind == "zero":
                w = zero_init_dense(fan_out, fan_in)
            else:
                var = 2.0 / (fan_in + fan_out) if kind == "xavier" else 2.0 / fan_in
                std = math.sqrt(var) / _TRUNC_STD
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
