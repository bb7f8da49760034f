"""The reference's training step: the loss, the train-time augmentation, the
learning-rate schedules and the two optimizers, in plain PyTorch, and
:func:`follow`, which takes a model through the first steps of a run and
reports what the check compares.

- Loss: label-smoothed NLL over log-probabilities, ``1 - s`` on the label
  and ``s / (n - 1)`` on each other class, averaged over clouds (or points).
- Augmentation (part segmentation): each cloud scaled by ``U[0.8, 1.25)``,
  then every channel shifted by ``U[-0.1, 0.1)``; the draws of step ``t``
  come from a generator on the card seeded from ``(seed, 2, t)`` by numpy's
  ``SeedSequence``, scales first, as the trainer of ``mpa_tpu`` draws them.
- SGD: heavy-ball momentum, no dampening, L2 ``wd * p`` added to the
  gradient; Adam: the same L2 in the gradient (not decoupled), bias-corrected
  moments, ``eps`` outside the square root.
- Schedules: cosine from ``lr`` to ``eta_min`` over ``epochs``, or step
  decay ``lr * gamma ** floor(epoch / step)``, by the epoch ``step //
  steps_per_epoch``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

AUG_STREAM = 2


def smooth_nll(log_probs: torch.Tensor, labels: torch.Tensor, smoothing: float) -> torch.Tensor:
    n = log_probs.shape[-1]
    lp = log_probs.reshape(-1, n)
    target = torch.full_like(lp, smoothing / (n - 1))
    target.scatter_(1, labels.reshape(-1, 1), 1.0 - smoothing)
    return -(target * lp).sum(dim=-1).mean()


def stream_generator(seed: int, stream: int, step: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def scale_shift(points: torch.Tensor, seed: int, step: int) -> torch.Tensor:
    g = stream_generator(seed, AUG_STREAM, step, points.device)
    B, _, C = points.shape
    scale = 0.8 + (1.25 - 0.8) * torch.rand((B, 1, 1), generator=g, device=points.device)
    points = points * scale
    shift = -0.1 + 0.2 * torch.rand((B, 1, C), generator=g, device=points.device)
    return points + shift


def learning_rate(opt: dict, step: int, steps_per_epoch: int) -> float:
    epoch = step // steps_per_epoch
    if opt["scheduler"] == "cos":
        t = min(max(epoch / opt["epochs"], 0.0), 1.0)
        return opt["eta_min"] + 0.5 * (opt["lr"] - opt["eta_min"]) * (1.0 + math.cos(math.pi * t))
    return opt["lr"] * opt["gamma"] ** math.floor(epoch / opt["decay_step"])


class Optimizer:
    """SGD or Adam over ``params`` (name -> tensor) as ``opt`` states them."""

    def __init__(self, opt: dict, params: Dict[str, torch.Tensor]):
        self.opt = opt
        self.params = params
        self.state = {n: {} for n in params}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        """Update the parameters in place; returns the gradient each took,
        the L2 term included."""
        self.t += 1
        wd, taken = self.opt["weight_decay"], {}
        with torch.no_grad():
            for n, p in self.params.items():
                g = grads[n] + wd * p
                taken[n] = g
                st = self.state[n]
                if self.opt["kind"] == "sgd":
                    buf = g.clone() if "buf" not in st else self.opt["momentum"] * st["buf"] + g
                    st["buf"] = buf
                    p -= lr * buf
                else:
                    b1, b2, eps = self.opt["beta1"], self.opt["beta2"], self.opt["eps"]
                    m = (1 - b1) * g if "m" not in st else b1 * st["m"] + (1 - b1) * g
                    v = (1 - b2) * g * g if "v" not in st else b2 * st["v"] + (1 - b2) * g * g
                    st["m"], st["v"] = m, v
                    m_hat = m / (1 - b1 ** self.t)
                    v_hat = v / (1 - b2 ** self.t)
                    p -= lr * m_hat / (torch.sqrt(v_hat) + eps)
        return taken


def follow(model: torch.nn.Module, forward: Callable, batches: Sequence, opt: dict, seed: int,
           steps_per_epoch: int, augment: bool) -> dict:
    """Train ``model`` (its weights loaded, on the card) through
    ``len(batches)`` steps, ``forward(model, inputs, generator)`` giving
    log-probabilities; the dropout generator is seeded with ``seed``, as is
    the augmentation's stream. Returns ``losses`` (one a step), ``grad``
    (each leaf's gradient norm as the optimizer took it in step 1, L2 term
    included), ``raw_grad`` (without it) and ``change`` (each leaf's norm of
    ``p_after - p_before`` over all the steps)."""
    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    optimizer = Optimizer(opt, params)
    generator = torch.Generator(device=device).manual_seed(seed)
    model.train()
    losses: List[float] = []
    out = {}
    for step, (points, extra, labels) in enumerate(batches):
        if augment:
            points = scale_shift(points, seed, step)
        for p in params.values():
            p.grad = None
        loss = smooth_nll(forward(model, points, extra, generator), labels, opt["smoothing"])
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        taken = optimizer.step(grads, learning_rate(opt, step, steps_per_epoch))
        losses.append(float(loss.detach()))
        if step == 0:
            out["grad"] = {n: float(g.norm()) for n, g in taken.items()}
            out["raw_grad"] = {n: float(g.norm()) for n, g in grads.items()}
    out["losses"] = losses
    out["change"] = {n: float((p.detach() - before[n]).norm()) for n, p in params.items()}
    return out
