"""Train and eval steps (counterpart of ``mpa_tpu/train/loop.py``).

``mpa_tpu`` builds a pure jitted step over an immutable ``TrainState``;
here the state is a small mutable object (model, optimizer, dropout
generator, step count) and the step updates it in place.

Optimizer semantics follow ``mpa_tpu``'s optax chains:

- ``adam-l2``: L2 folded into the gradient before the moments, which is
  ``torch.optim.Adam(weight_decay=wd)`` (not AdamW);
- ``sgd``: heavy-ball momentum with the same in-gradient L2,
  ``torch.optim.SGD(momentum, dampening=0, weight_decay=wd)``.

Weight decay applies to every parameter, BatchNorm scales and biases
included, as ``optax.add_decayed_weights`` does. A parameter that takes no
part in the loss (``LocalTrans.q``) gets a zero gradient in JAX, which the
decay term then moves through Adam; torch would leave its ``.grad`` as None
and skip it, so the step gives every such parameter a zero gradient first.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from mpa_tpu_torch.configs import TrainConfig
from mpa_tpu_torch.models.markov_pose import rotation_geodesic_loss
from mpa_tpu_torch.train.losses import completion_loss, smooth_cls_loss, smooth_seg_loss
from mpa_tpu_torch.train.schedules import Schedule, cosine_schedule, step_decay_schedule


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: Optional[torch.Generator] = None  # dropout masks, on the model's device
    step: int = 0


def make_optimizer(
    kind: str,
    params: Iterable[torch.Tensor],
    learning_rate: float,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
) -> torch.optim.Optimizer:
    params = list(params)
    if kind == "adam-l2":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum, dampening=0.0,
                               weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {kind}")


def create_train_state(model: nn.Module, cfg: TrainConfig, device: torch.device) -> TrainState:
    """Move ``model`` to ``device`` and pair it with ``cfg``'s optimizer and a
    dropout generator on that device, seeded with ``cfg.seed``."""
    model.to(device)
    optimizer = make_optimizer(cfg.optimizer, model.parameters(), cfg.learning_rate,
                               cfg.weight_decay, cfg.momentum)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return TrainState(model, optimizer, generator)


def make_train_step(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    schedule: Schedule,
    steps_per_epoch: int,
):
    """Build ``train_step(state, points, labels) -> loss`` (detached);
    ``points`` is whatever the model takes (a part-seg model takes the pair
    ``(points, category one-hot)``).

    The learning rate of step ``t`` (counted from 0) is
    ``schedule(t // steps_per_epoch)``, as ``mpa_tpu``'s optax schedule reads
    the step count before its update. The model runs in train mode.
    """

    def train_step(state: TrainState, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        lr = float(schedule(state.step // steps_per_epoch))
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model(points, generator=state.generator), labels)
        loss.backward()
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step


def make_schedule(cfg: TrainConfig) -> Schedule:
    """``cfg``'s per-epoch learning rate: cosine to ``eta_min`` over
    ``epochs``, or step decay."""
    if cfg.scheduler == "cos":
        return cosine_schedule(cfg.learning_rate, cfg.epochs, cfg.eta_min)
    if cfg.scheduler == "step":
        return step_decay_schedule(cfg.learning_rate, cfg.decay_step, cfg.decay_gamma)
    raise ValueError(f"unknown scheduler {cfg.scheduler}")


def make_cls_train_step(cfg: TrainConfig, steps_per_epoch: int):
    """The classification step of ``cfg``: label-smoothed NLL under its
    per-epoch schedule."""
    smoothing = cfg.label_smoothing
    return make_train_step(lambda out, labels: smooth_cls_loss(out, labels, smoothing),
                           make_schedule(cfg), steps_per_epoch)


def _seg_train_step(cfg: TrainConfig, steps_per_epoch: int):
    smoothing = cfg.label_smoothing
    return make_train_step(lambda out, labels: smooth_seg_loss(out, labels, smoothing),
                           make_schedule(cfg), steps_per_epoch)


def make_partseg_train_step(cfg: TrainConfig, steps_per_epoch: int):
    """The part-seg step of ``cfg``: per-point label-smoothed NLL under its
    per-epoch schedule. Call it as ``step(state, (points, onehot), labels)``
    with labels ``[B, N]``."""
    return _seg_train_step(cfg, steps_per_epoch)


def make_semseg_train_step(cfg: TrainConfig, steps_per_epoch: int):
    """The semantic-segmentation step of ``cfg`` (``s3dis_semseg``: SGD 0.1,
    momentum 0.9, wd 1e-4, cosine to 1e-3, smoothing 0.1, head dropout 0.5
    from the state's generator): per-point label-smoothed NLL. Call it as
    ``step(state, blocks [B, N, 9], labels [B, N])``."""
    return _seg_train_step(cfg, steps_per_epoch)


def make_pose_train_step(cfg: TrainConfig, steps_per_epoch: int):
    """The pose step of ``cfg`` (``pose_modelnet40``: adam-l2 1e-3, wd 1e-4,
    cosine to 1e-5, head dropout 0.1 from the state's generator): the mean
    geodesic angle. Call it as ``step(state, points [B, N, 3], rotations
    [B, 3, 3])``."""
    return make_train_step(rotation_geodesic_loss, make_schedule(cfg), steps_per_epoch)


def make_completion_train_step(cfg: TrainConfig, steps_per_epoch: int):
    """The completion step of ``cfg`` (``completion``: the pose recipe): the
    coarse and the fine cloud's Chamfer distance to the full one. Call it as
    ``step(state, partial [B, N, 3], full [B, M, 3])``."""
    return make_train_step(completion_loss, make_schedule(cfg), steps_per_epoch)


# The train step of each task, as ``TRAIN_STEPS[cfg.task](cfg, steps_per_epoch)``.
TRAIN_STEPS = {"cls": make_cls_train_step, "partseg": make_partseg_train_step,
               "semseg": make_semseg_train_step, "pose": make_pose_train_step,
               "completion": make_completion_train_step}


def make_eval_step():
    """Build ``eval_step(state, points) -> the model's output`` (eval mode,
    no grad): log-probs, pose's rotations, completion's ``(coarse, fine)``;
    ``points`` as in :func:`make_train_step`."""

    def eval_step(state: TrainState, points: torch.Tensor):
        state.model.eval()
        with torch.inference_mode():
            return state.model(points)

    return eval_step
