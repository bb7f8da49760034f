"""Best-metric checkpointing over ``torch.save`` (counterpart of
``mpa_tpu/train/checkpoint.py``).

The checkpoint under ``directory`` is one file, ``best``, holding the
model's ``state_dict`` (BatchNorm statistics included), the optimizer's
``state_dict`` and class name, the step and the metric. A save writes
``best.new`` in full, syncs it to disk and then swaps it in, so a crash
leaves a complete checkpoint: ``restore`` falls back to ``best.new``, then
``best.old``.
``restore`` reads with ``torch.load(weights_only=True)``, which builds
tensors and plain containers only, never arbitrary objects.

Restore refuses, with a ``ValueError`` that names the entry, a checkpoint
whose model entries do not match the target's: a missing or extra key, a
shape, a dtype, or BatchNorm statistics that are missing or extra.
``mpa_tpu``'s restore checks the parameter tree and shapes only, neither
dtypes nor the BatchNorm statistics: a checkpoint without them would load
there and evaluate with fresh running statistics.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from mpa_tpu_torch.train.loop import TrainState

_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _check_model_entries(got: dict, want: dict, where: str) -> None:
    def is_bn(key):
        return key.rsplit(".", 1)[-1] in _BN_BUFFERS

    missing = [k for k in want if k not in got]
    extra = [k for k in got if k not in want]
    for keys, what in ((missing, "missing"), (extra, "extra")):
        bn = [k for k in keys if is_bn(k)]
        if bn:
            raise ValueError(f"checkpoint {where}: BatchNorm statistics {what}: {bn[:4]}"
                             f"{' ...' if len(bn) > 4 else ''} ({len(bn)} entries)")
        if keys:
            raise ValueError(f"checkpoint {where}: {what} model entries {keys[:4]}"
                             f"{' ...' if len(keys) > 4 else ''} ({len(keys)} entries): "
                             "a different model architecture")
    for key, w in want.items():
        g = got[key]
        if not torch.is_tensor(g):
            raise ValueError(f"checkpoint {where}: {key} is a {type(g).__name__}, not a tensor")
        if g.shape != w.shape:
            raise ValueError(f"checkpoint {where}: {key} has shape {tuple(g.shape)} where the "
                             f"model has {tuple(w.shape)}: a different model configuration")
        if g.dtype != w.dtype:
            raise ValueError(f"checkpoint {where}: {key} has dtype {g.dtype} where the model "
                             f"has {w.dtype}")


class BestCheckpointer:
    """Keeps the checkpoint of the best metric (the maximum) under ``directory``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, "best")
        self.best_metric: Optional[float] = None

    def save_if_best(self, state: TrainState, metric: float) -> bool:
        """Save ``state`` when ``metric`` beats the best so far; returns
        whether it did."""
        if self.best_metric is not None and metric <= self.best_metric:
            return False
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "optimizer_class": type(state.optimizer).__name__,
            "step": int(state.step),
            "metric": float(metric),
        }
        new, old = self.path + ".new", self.path + ".old"
        for stale in (new, old):
            if os.path.exists(stale):
                os.remove(stale)
        with open(new, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(self.path):
            os.replace(self.path, old)
        os.replace(new, self.path)
        if os.path.exists(old):
            os.remove(old)
        self.best_metric = float(metric)
        return True

    def restore(self, state: TrainState, *,
                restore_optimizer: bool = True) -> Optional[Tuple[TrainState, float]]:
        """Load the checkpoint into ``state`` in place; returns ``(state,
        metric)``, or None when there is none.

        ``restore_optimizer=False`` loads the weights, BatchNorm statistics and
        step only, so a checkpoint of any optimizer goes into an eval state
        (lr-0 SGD); ``True`` also loads the optimizer's state, which must be
        of the same class.
        """
        if not os.path.exists(self.path):
            for fallback in (self.path + ".new", self.path + ".old"):
                if os.path.exists(fallback):
                    os.replace(fallback, self.path)
                    break
            else:
                return None
        payload = torch.load(self.path, map_location="cpu", weights_only=True)
        _check_model_entries(payload["model"], state.model.state_dict(), self.path)
        if restore_optimizer:
            kind = type(state.optimizer).__name__
            if payload["optimizer_class"] != kind:
                raise ValueError(f"checkpoint {self.path}: optimizer "
                                 f"{payload['optimizer_class']} where the state has {kind}")
            state.optimizer.load_state_dict(payload["optimizer"])
        state.model.load_state_dict(payload["model"], strict=True)
        state.step = int(payload["step"])
        self.best_metric = float(payload["metric"])
        return state, self.best_metric
