"""Weights from the seed, made on the device in one draw, in float32.

Every float leaf of the reference's weight table (``reference/layers.py``)
takes a slice of one standard normal vector drawn by a ``torch.Generator``
on the card: a dense kernel ``z * sqrt(2 / (1 + 0.2^2) / fan_in)`` (He's
spread for LeakyReLU(0.2), so activations keep their scale through the
layers), a bias ``0.02 z``, a norm's scale ``1 + 0.1 z`` and shift
``0.05 z``, its running mean ``0.05 z`` and running variance ``exp(0.1 z)``.
The same table of tensors is loaded into the program and into the
reference.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.layers import BIAS, DENSE, MEAN, SCALE, SHIFT, VAR


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of the run seeded with ``seed``."""
    words = [seed & 0xFFFFFFFF, seed >> 32] + [ord(c) for c in stream]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def make(table, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _, _ in table)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    z = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind, fan_in in table:
        n = math.prod(shape)
        x = z[at:at + n].view(shape)
        at += n
        if kind == DENSE:
            x = x * math.sqrt(2.0 / 1.04 / fan_in)
        elif kind == BIAS:
            x = 0.02 * x
        elif kind == SCALE:
            x = 1.0 + 0.1 * x
        elif kind in (SHIFT, MEAN):
            x = 0.05 * x
        elif kind == VAR:
            x = torch.exp(0.1 * x)
        out[name] = x
    return out


def load_into_program(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the program's ``model`` by name. Every float
    leaf of the model has to be named, and no name may be left over: only
    the program's own step counters (``num_batches_tracked``) stay."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"weight table and program disagree: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
