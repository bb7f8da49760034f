"""The program's training path as its trainer runs it: the preset's model and
optimizer state (``train.create_train_state``), its step
(``train.TRAIN_STEPS[task]``), the host batches of ``cli.train`` through
``data.pipeline.prefetch_to_device``, and ``cli.train.augment_batch`` on the
card before each step (``mpa_tpu_torch/cli/train.py:622-640``). The one
departure from the trainer's epoch loop: the batches of successive passes
over the pool (each pass shuffled anew) come through one feed, so no pass
boundary stalls the window.

The program is imported inside the functions, once the harness has checked
for the card.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


class Trainer:
    def __init__(self, sizes: dict, seed: int, batch: int, steps_per_epoch: int,
                 device: torch.device):
        from mpa_tpu_torch.cli import train as cli_train
        from mpa_tpu_torch.configs import PRESETS, model_kwargs
        from mpa_tpu_torch.models import get_model
        from mpa_tpu_torch.train import TRAIN_STEPS, create_train_state

        self._cli = cli_train
        self.cfg = PRESETS[sizes["preset"]].with_overrides(
            model=sizes["model"], seed=seed, batch_size=batch, num_points=sizes["num_points"])
        self.device = device
        model = get_model(self.cfg.model, **model_kwargs(self.cfg))
        self.state = create_train_state(model, self.cfg, device)
        self.train_step = TRAIN_STEPS[self.cfg.task](self.cfg, steps_per_epoch)
        self.partseg = self.cfg.task == "partseg"

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def feed(self, arrays: Sequence[np.ndarray], rng: np.random.Generator,
             record: Optional[List[tuple]] = None, keep: int = 0) -> Iterator:
        """The device batches of endless shuffled passes over ``arrays``; the
        first ``keep`` host batches are appended to ``record``."""
        from mpa_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device

        passes = itertools.chain.from_iterable(
            batch_iterator(arrays, self.cfg.batch_size, rng=rng) for _ in itertools.count())

        def host(batch):
            if record is not None and len(record) < keep:
                record.append(tuple(np.copy(a) for a in batch))
            return self._cli.host_batch(self.cfg, batch)

        return prefetch_to_device(passes, self.device, transform=host)

    def step(self, inputs, labels) -> torch.Tensor:
        """One step of the trainer's loop; the loss stays on the card."""
        raw = inputs[0] if self.partseg else inputs
        points = self._cli.augment_batch(self.cfg, raw, self.state.step)
        inputs = (points, inputs[1]) if self.partseg else points
        return self.train_step(self.state, inputs, labels)

    def taken_gradients(self) -> Dict[str, torch.Tensor]:
        """Each parameter's gradient as the optimizer took it in its first
        step, read from its state: SGD's momentum buffer, or Adam's first
        moment over ``1 - beta1``."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        out = {}
        for group in self.state.optimizer.param_groups:
            for p in group["params"]:
                st = self.state.optimizer.state.get(p, {})
                if "momentum_buffer" in st:
                    out[names[id(p)]] = st["momentum_buffer"].detach().clone()
                elif "exp_avg" in st:
                    out[names[id(p)]] = st["exp_avg"].detach() / (1.0 - group["betas"][0])
                else:  # the optimizer never stepped
                    out[names[id(p)]] = torch.zeros_like(p)
        return out
