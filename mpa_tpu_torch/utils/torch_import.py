"""Import a reference PyTorch checkpoint into the port's models
(counterpart of ``mpa_tpu/utils/torch_import.py``).

A reference ``checkpoints/best_model.pth`` (``{"model_state_dict": ...}``,
or the bare state dict) loads into ``MarkovClassifier`` (the reference's
cls ``Model``) or ``MarkovPartSeg`` (part-seg ``get_model``) without the
reference code. The port's modules carry the flax names, which differ from
the reference's only in these places (``reference_keys`` is the map):

- ``keep_high`` is the reference's ``keepHigh``, and cls's ``final_bn`` its
  ``keepHigh.bn``;
- a LocalMerge's branches ``xyz_trans`` / ``feature_trans`` /
  ``feature_trans2`` are ``xyz_Trans`` / ``feature_Trans`` (cls) or
  ``feature_Trans1`` (part-seg) / ``feature_Trans2``;
- a ``LinearUnit``'s ``norm`` is the reference ``Linear``'s ``norm2`` where
  the port's is a BatchNorm and ``norm1`` where it is a LayerNorm (the
  reference builds both and its inverted ``bn`` flag picks one; the
  destination decides, as the template does in ``mpa_tpu``).

Reference ``nn.Linear`` weights are ``[out, in]``, as the port's are, so
they go across untransposed. A ``module.`` prefix (DataParallel) is
stripped. Every checkpoint key the model does not read (``normal_Trans``,
which the reference builds and never calls, the unused norm of each site,
the BatchNorm counters) is reported in ``skipped_torch_keys``; the port's
``num_batches_tracked`` start at 0, as ``from_jax_variables`` sets them.

The loader is ``torch.load(weights_only=True)``: a checkpoint is a
third-party file, and full unpickling runs whatever code it holds, so it
happens only behind ``allow_pickle=True``, with a warning.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict

import torch
from torch import nn

# Reference names of the port's (flax's) module names, by task.
_RENAMES = {
    "cls": {"keep_high": "keepHigh", "xyz_trans": "xyz_Trans",
            "feature_trans": "feature_Trans", "feature_trans2": "feature_Trans2"},
    "partseg": {"keep_high": "keepHigh", "xyz_trans": "xyz_Trans",
                "feature_trans": "feature_Trans1", "feature_trans2": "feature_Trans2"},
}


def reference_keys(task: str, model: nn.Module) -> Dict[str, str]:
    """``{port state-dict key: reference checkpoint key}`` for every entry of
    ``model`` (a port ``MarkovClassifier`` for ``task='cls'``, a
    ``MarkovPartSeg`` for ``'partseg'``) but the ``num_batches_tracked``
    counters."""
    if task not in _RENAMES:
        raise ValueError(f"task {task!r}: the reference checkpoints are 'cls' or 'partseg'")
    renames = _RENAMES[task]
    out = {}
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        ref = []
        for i, part in enumerate(parts[:-1]):
            if part == "norm":
                norm = model.get_submodule(".".join(parts[:i + 1]))
                ref.append("norm1" if isinstance(norm, nn.LayerNorm) else "norm2")
            elif task == "cls" and part == "final_bn" and parts[i - 1:i] == ["keep_high"]:
                ref.append("bn")
            else:
                ref.append(renames.get(part, part))
        out[key] = ".".join(ref + parts[-1:])
    return out


def _state_dict(ckpt: Any) -> Dict[str, torch.Tensor]:
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def import_state_dict(ckpt: Any, task: str, model: nn.Module) -> dict:
    """Load a reference checkpoint's state dict (``ckpt``, as ``torch.load``
    returns it) into ``model`` in place; returns the report
    ``{"skipped_torch_keys": [...]}``. Raises KeyError for an entry of the
    model the checkpoint lacks and ValueError for a shape that differs."""
    tensors = _state_dict(ckpt)
    own = model.state_dict()
    new, used = {}, set()
    for key, ref in reference_keys(task, model).items():
        if ref not in tensors:
            raise KeyError(f"{ref!r} (for {key!r}) is not in the checkpoint")
        value = torch.as_tensor(tensors[ref]).detach().cpu()
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{ref!r}: shape {tuple(value.shape)}, the model's {key!r} has "
                             f"{tuple(own[key].shape)}")
        new[key] = value.to(own[key].dtype)
        used.add(ref)
    for key in own:
        if key.endswith("num_batches_tracked"):
            new[key] = torch.zeros_like(own[key])
    model.load_state_dict(new, strict=True)
    return {"skipped_torch_keys": sorted(set(tensors) - used)}


def import_reference_checkpoint(path: str, task: str, model: nn.Module,
                                allow_pickle: bool = False) -> dict:
    """Read the reference checkpoint at ``path`` into ``model``
    (:func:`import_state_dict`); ``task`` is ``'cls'`` or ``'partseg'``.
    Loads weights only unless ``allow_pickle``, which warns."""
    if allow_pickle:
        warnings.warn("allow_pickle=True executes arbitrary code embedded in the checkpoint; "
                      "only use on checkpoints you trust.", stacklevel=2)
    ckpt = torch.load(path, map_location="cpu", weights_only=not allow_pickle)
    return import_state_dict(ckpt, task, model)
