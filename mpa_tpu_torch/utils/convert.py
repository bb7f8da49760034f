"""Carry ``mpa_tpu`` (flax) variables into a port model's ``state_dict``.

The port's submodules carry the flax module names, so the key map is
mechanical. Flax path ``params/a/b/kernel`` (a Dense ``[in, out]``) becomes
``a.b.weight`` ``[out, in]``; ``params/a/bias`` becomes ``a.bias``; a norm's
``params/a/scale`` becomes ``a.weight``; ``batch_stats/a/mean`` and ``var``
become ``a.running_mean`` and ``a.running_var`` (with ``a.num_batches_tracked``
set to 0, a buffer flax has no counterpart for); any other ``params/a/p``, a
raw parameter, becomes ``a.p`` as it is (no transpose). Values become float32, but
float64 leaves (``mpa_tpu`` run with ``jax_enable_x64``) stay float64.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_COLLECTIONS = ("params", "batch_stats")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _torch_entries(key: str, value: np.ndarray) -> Dict[str, torch.Tensor]:
    parts = key.split("/")
    hits = [i for i, p in enumerate(parts) if p in _COLLECTIONS]
    if not hits or len(parts) < hits[0] + 2:
        raise KeyError(f"not a flax variable path: {key!r}")
    collection = parts[hits[0]]
    path, leaf = parts[hits[0] + 1 : -1], parts[-1]

    def name(attr: str) -> str:  # a leaf of the root module keeps its bare name
        return ".".join(path + [attr])

    value = np.asarray(value)
    t = torch.from_numpy(np.array(value, dtype=np.float64 if value.dtype == np.float64
                                  else np.float32))
    if collection == "params":
        if leaf == "kernel":
            if t.dim() != 2:
                raise ValueError(f"{key}: Dense kernel must be 2-D, got {tuple(t.shape)}")
            return {name("weight"): t.t().contiguous()}
        if leaf == "bias":
            return {name("bias"): t}
        if leaf == "scale":
            return {name("weight"): t}
        # Any other leaf is a raw parameter (``self.param`` outside a Dense or
        # a norm): NetVLAD's ``cluster_weights2``, the displacement kernels'
        # ``displacement`` and ``weights``. It keeps its name and shape.
        return {name(leaf): t}
    if leaf == "mean":
        return {name("running_mean"): t,
                name("num_batches_tracked"): torch.tensor(0, dtype=torch.long)}
    if leaf == "var":
        return {name("running_var"): t}
    raise KeyError(f"unknown flax leaf {key!r}")


def from_jax_variables(
    variables: Mapping, model: nn.Module
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Convert flax variables for ``model``.

    Args:
      variables: flat ``{"variables/params/keep_high/la0/xyz_trans/k/kernel":
        array, ...}`` (the form ``tests/oracle_cache.py`` stores; any prefix
        before ``params``/``batch_stats`` is ignored) or the nested flax dict.
      model: the port module the state dict is for.

    Returns:
      ``(state_dict, unused_keys)``: the entries ``model`` has, ready for
      ``model.load_state_dict(state_dict, strict=True)``, and the input keys
      that map to nothing in ``model`` (parameters the JAX model never reads),
      reported rather than dropped silently.
    """
    flat = _flatten(variables)
    wanted = set(model.state_dict().keys())
    state: Dict[str, torch.Tensor] = {}
    unused: List[str] = []
    for key in sorted(flat):
        entries = _torch_entries(key, flat[key])
        if not all(name in wanted for name in entries):
            unused.append(key)
            continue
        state.update(entries)
    return state, unused
