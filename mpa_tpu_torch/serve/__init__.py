"""Inference entry point (counterpart of ``mpa_tpu.serve.load_inference``).

``load_classifier`` builds the classifier of a preset on a device, with
weights carried over from ``mpa_tpu`` variables or initialised from a seed,
and returns a callable ``points [B, N, 3] -> log-probs [B, num_classes]``
that runs in eval mode under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from mpa_tpu_torch.configs import PRESETS
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.utils.convert import from_jax_variables
from mpa_tpu_torch.utils.device import DeviceLike, resolve_device
from mpa_tpu_torch.utils.init import init_like_flax


class Classifier:
    """A loaded classifier: call it on ``[B, N, 3]`` points (tensor or numpy)."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    def __call__(self, points) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(points) if not torch.is_tensor(points) else points,
                            dtype=torch.float32).to(self.device)
        if x.dim() != 3 or x.shape[-1] < 3:
            raise ValueError(f"points must be [B, N, 3], got {tuple(x.shape)}")
        with torch.inference_mode():
            return self.model(x.contiguous())


def load_classifier(
    preset: str = "scanobjectnn_cls",
    variables: Optional[Mapping] = None,
    *,
    device: DeviceLike = None,
    seed: int = 0,
) -> Classifier:
    """Build the preset's classifier on ``device`` (default ``cuda``).

    Args:
      preset: a key of ``mpa_tpu_torch.configs.PRESETS``.
      variables: ``mpa_tpu`` variables as numpy arrays (flat
        ``params/...``/``batch_stats/...`` keys or the nested dict), loaded
        strictly; None initialises from ``seed`` with flax's default
        initialisers.
      device: ``"cuda"`` (default) or ``"cpu"``; CUDA without a card raises.
      seed: seed of the CPU generator used when ``variables`` is None, so the
        same seed gives the same weights on every device.
    """
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[preset]
    dev = resolve_device(device)
    model = get_model(cfg.model, num_classes=cfg.num_classes)
    if variables is None:
        init_like_flax(model, torch.Generator().manual_seed(seed))
    else:
        state, _ = from_jax_variables(variables, model)
        model.load_state_dict(state, strict=True)
    model.eval().to(dev)
    return Classifier(model, dev)
