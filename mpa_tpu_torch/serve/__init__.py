"""Inference entry points (counterpart of ``mpa_tpu.serve.load_inference``).

``load_classifier`` builds the classifier of a preset on a device, with
weights carried over from ``mpa_tpu`` variables or initialised from a seed,
and returns a callable ``points [B, N, 3] -> log-probs [B, num_classes]``
that runs in eval mode under ``torch.inference_mode()``. ``load_segmenter``
does the same for a part-seg preset: ``(points [B, N, 3], category [B]) ->
per-point log-probs [B, N, num_parts]`` (``shapenetpart_fp`` too, and the
window modes through ``neighbor_mode``), ``load_semantic_segmenter`` for
a semantic-segmentation preset: ``blocks [B, N, 9] -> per-point log-probs
[B, N, num_classes]``, ``load_pose_regressor`` for ``pose_modelnet40``:
``points [B, N, 3] -> rotations [B, 3, 3]``, and ``load_completer`` for
``completion``: ``partial [B, N, 3] -> (coarse [B, 256, 3], fine [B, N +
1024, 3])``. ``mpa_tpu`` serves every model through ``serve/export.py``;
these are its counterparts.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from mpa_tpu_torch.configs import PRESETS, model_kwargs
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.utils.convert import from_jax_variables
from mpa_tpu_torch.utils.device import DeviceLike, resolve_device
from mpa_tpu_torch.utils.init import init_like_flax


def _as_tensor(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    value = value if torch.is_tensor(value) else np.asarray(value)
    return torch.as_tensor(value, dtype=dtype).to(device)


def _points(points, device: torch.device) -> torch.Tensor:
    x = _as_tensor(points, torch.float32, device)
    if x.dim() != 3 or x.shape[-1] < 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(x.shape)}")
    return x.contiguous()


class Classifier:
    """A loaded classifier: call it on ``[B, N, 3]`` points (tensor or numpy)."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    def __call__(self, points) -> torch.Tensor:
        x = _points(points, self.device)
        with torch.inference_mode():
            return self.model(x)


class Segmenter:
    """A loaded part segmenter: call it on ``[B, N, 3]`` points and ``[B]``
    integer shape categories (tensors or numpy)."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    def __call__(self, points, category) -> torch.Tensor:
        x = _points(points, self.device)
        cat = _as_tensor(category, torch.long, self.device)
        n_cat = self.model.num_categories
        if cat.dim() != 1 or cat.shape[0] != x.shape[0]:
            raise ValueError(f"category must be [B={x.shape[0]}], got {tuple(cat.shape)}")
        if cat.numel() and not (0 <= int(cat.min()) and int(cat.max()) < n_cat):
            raise ValueError(f"category values must lie in [0, {n_cat})")
        onehot = torch.nn.functional.one_hot(cat, n_cat).to(torch.float32)
        with torch.inference_mode():
            return self.model((x, onehot))


class SemanticSegmenter:
    """A loaded semantic segmenter: call it on ``[B, N, 3 + F]`` blocks (xyz
    and the model's F extra features; tensor or numpy)."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    def __call__(self, points) -> torch.Tensor:
        x = _points(points, self.device)
        want = 3 + self.model.feature_channels
        if x.shape[-1] != want:
            raise ValueError(f"points must be [B, N, {want}], got {tuple(x.shape)}")
        with torch.inference_mode():
            return self.model(x)


def _load(preset: str, task: str, variables: Optional[Mapping], device: DeviceLike, seed: int,
          **overrides):
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[preset].with_overrides(**overrides)
    if cfg.task != task:
        raise ValueError(f"preset {preset!r} is a {cfg.task!r} preset, not {task!r}")
    dev = resolve_device(device)
    model = get_model(cfg.model, **model_kwargs(cfg))
    if variables is None:
        init_like_flax(model, torch.Generator().manual_seed(seed))
    else:
        state, _ = from_jax_variables(variables, model)
        model.load_state_dict(state, strict=True)
    return model.eval().to(dev), dev


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
    return Classifier(*_load(preset, "cls", variables, device, seed))


def load_segmenter(
    preset: str = "shapenetpart",
    variables: Optional[Mapping] = None,
    *,
    device: DeviceLike = None,
    seed: int = 0,
    **overrides,
) -> Segmenter:
    """Build the preset's part segmenter (``shapenetpart``: ``markov_partseg``,
    ``shapenetpart_fp``: ``markov_partseg_fp``) on ``device`` (default
    ``cuda``); ``preset``, ``variables``, ``device`` and ``seed`` as
    :func:`load_classifier`. ``overrides`` replace fields of the preset
    before the model is built: ``num_points`` (the FPS ladder halves it four
    times; the clouds must have that many points) and, for
    ``markov_partseg``, ``neighbor_mode`` (``"exact"``, ``"window"`` or
    ``"window_all"``), so the Morton-window segmenter is
    ``load_segmenter(neighbor_mode="window")``."""
    return Segmenter(*_load(preset, "partseg", variables, device, seed, **overrides))


def load_semantic_segmenter(
    preset: str = "s3dis_semseg",
    variables: Optional[Mapping] = None,
    *,
    device: DeviceLike = None,
    seed: int = 0,
    **overrides,
) -> SemanticSegmenter:
    """Build the preset's semantic segmenter on ``device`` (default
    ``cuda``); ``preset``, ``variables``, ``device`` and ``seed`` as
    :func:`load_classifier`. ``overrides`` replace fields of the preset
    before the model is built: ``num_points`` (the FPS ladder halves it four
    times; the blocks must have that many points), ``batch_size`` and
    ``neighbor_mode`` (``"exact"``, ``"window"`` or ``"window_all"``), so the
    16384-point ``window_all`` configuration is
    ``load_semantic_segmenter(num_points=16384, neighbor_mode="window_all")``."""
    return SemanticSegmenter(*_load(preset, "semseg", variables, device, seed, **overrides))


def load_pose_regressor(
    preset: str = "pose_modelnet40",
    variables: Optional[Mapping] = None,
    *,
    device: DeviceLike = None,
    seed: int = 0,
) -> Classifier:
    """Build the preset's pose regressor (``markov_pose``) on ``device``
    (default ``cuda``); arguments as :func:`load_classifier`. Call it on
    ``[B, N, 3]`` points (tensor or numpy) for ``[B, 3, 3]`` rotation
    matrices."""
    return Classifier(*_load(preset, "pose", variables, device, seed))


def load_completer(
    preset: str = "completion",
    variables: Optional[Mapping] = None,
    *,
    device: DeviceLike = None,
    seed: int = 0,
) -> Classifier:
    """Build the preset's completion model (``markov_completion``) on
    ``device`` (default ``cuda``); arguments as :func:`load_classifier`. Call
    it on a partial cloud ``[B, N, 3]`` (tensor or numpy) of at least the
    ladder's first 512 points for ``(coarse [B, M, 3], fine [B, M * r + N,
    3])``."""
    return Classifier(*_load(preset, "completion", variables, device, seed))
