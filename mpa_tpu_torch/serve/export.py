"""Inference export (counterpart of ``mpa_tpu/serve/export.py``).

``torch.export`` captures the eval-mode model's forward under
``torch.no_grad()``, with its weights and BatchNorm statistics kept in the
program, shape-specialised to the example input (export one artifact per
serving batch, as ``mpa_tpu`` does). On the card the program calls the
port's hand-written kernels through their custom ops (``mpa::knn``,
``mpa::fps``, ...; ``ops/library.py``), the very launches an eager request
makes; on the CPU it holds their plain versions, traced op by op.

Artifact layout: ``<path>``, the ``torch.export.save`` archive, and
``<path>.json``, a manifest: the device the program runs on (a torch
artifact serves the device it was exported on), the input and output
shapes and dtypes (``in_avals`` / ``out_avals``), the torch version, the
custom-op namespace and ops the program calls, and the caller's fields.
Unlike ``mpa_tpu``'s StableHLO file, loading needs ``mpa_tpu_torch.ops``
importable, which registers those ops; :func:`load_exported` imports it. It
needs no model code.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

import mpa_tpu_torch.ops  # noqa: F401  (registers the mpa:: ops an artifact calls)
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.utils.device import DeviceLike, resolve_device

OP_NAMESPACE = library.NAMESPACE


def _to(inputs: Any, device: torch.device) -> Any:
    """A tensor, numpy array or tuple / list of them on ``device``."""
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(_to(x, device) for x in inputs)
    x = inputs if torch.is_tensor(inputs) else torch.as_tensor(np.asarray(inputs))
    return x.to(device)


def export_inference(model: torch.nn.Module, example_input: Any, *,
                     device: DeviceLike = None) -> torch.export.ExportedProgram:
    """Trace and export ``model``'s eval-mode forward with its weights.

    Args:
      model: a port model, called as ``model(inputs)``; it is moved to
        ``device``, traced in eval mode and left in the mode it was in.
      example_input: what the model takes, fixing every shape and dtype: a
        ``[B, N, 3]`` tensor, or ``(points, onehot [B, 16])`` for part-seg.
      device: ``"cuda"`` (default) or ``"cpu"``; CUDA without a card raises.

    Returns the ``torch.export.ExportedProgram`` (``save_exported`` writes
    it). An op the trace cannot take raises; nothing falls back.
    """
    dev = resolve_device(device)
    model = model.to(dev)
    example = _to(example_input, dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(model, (example,), strict=False)
    finally:
        model.train(was_training)


def _user_values(ep: torch.export.ExportedProgram):
    """The fake values of the program's user inputs and outputs."""
    sig = ep.graph_signature
    nodes = {n.name: n for n in ep.graph.nodes}
    ins = [nodes[name].meta["val"] for name in sig.user_inputs]
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out_node.args[0] if isinstance(a, torch.fx.Node)
            and a.name in sig.user_outputs]
    return ins, outs


def _aval(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def custom_ops(ep: torch.export.ExportedProgram) -> list:
    """The ``mpa::`` ops the program calls, sorted."""
    return sorted({str(n.target.name()) for n in ep.graph.nodes
                   if n.op == "call_function" and isinstance(n.target, torch._ops.OpOverload)
                   and n.target.namespace == OP_NAMESPACE})


def save_exported(ep: torch.export.ExportedProgram, path: str, *,
                  manifest: Optional[dict] = None) -> None:
    """Write the artifact (through a temporary file and ``os.replace``) and
    its JSON manifest beside it, ``<path>.json``."""
    tmp = path + ".tmp.pt2"  # torch.export.save expects the .pt2 suffix
    torch.export.save(ep, tmp)
    os.replace(tmp, path)
    ins, outs = _user_values(ep)
    man = {
        "device": str(ins[0].device) if ins else None,
        "in_avals": [_aval(t) for t in ins],
        "out_avals": [_aval(t) for t in outs],
        "torch": torch.__version__,
        "op_namespace": OP_NAMESPACE,
        "custom_ops": custom_ops(ep),
        "requires": f"import {library.REGISTERED_BY} before torch.export.load "
                    "(mpa_tpu_torch.serve.load_exported does): it registers the "
                    f"{OP_NAMESPACE}:: ops the program calls",
        "graph_nodes": len(ep.graph.nodes),
        **(manifest or {}),
    }
    with open(path + ".json", "w") as f:
        json.dump(man, f, indent=2)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Load an artifact written by :func:`save_exported` (the ``mpa::`` ops
    are registered by this module's import of ``mpa_tpu_torch.ops``)."""
    return torch.export.load(path)


def load_inference(path: str) -> Callable:
    """Load an artifact and return a plain callable ``inputs -> outputs``:
    the eval-mode forward it holds, under ``torch.inference_mode()``, on the
    device it was exported on (tensors or numpy arrays are moved there).
    Inputs of another shape or dtype than the export's raise ValueError."""
    ep = load_exported(path)
    ins, _ = _user_values(ep)
    device = ins[0].device if ins else torch.device("cpu")
    want = [_aval(t) for t in ins]
    module = ep.module()

    def infer(inputs):
        x = _to(inputs, device)
        got = [_aval(t) for t in (x if isinstance(x, (tuple, list)) else [x])]
        if got != want:
            raise ValueError(f"{path} takes {want}, got {got}")
        with torch.inference_mode():
            return module(x)

    return infer
