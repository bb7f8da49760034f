"""Training: losses, schedules, the train and eval steps, metrics."""

from mpa_tpu_torch.train.losses import cls_loss, smooth_cls_loss
from mpa_tpu_torch.train.loop import (
    TrainState,
    create_train_state,
    make_cls_train_step,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from mpa_tpu_torch.train.metrics import class_average_accuracy, instance_accuracy
from mpa_tpu_torch.train.schedules import cosine_schedule, step_decay_schedule

__all__ = [
    "TrainState",
    "class_average_accuracy",
    "cls_loss",
    "cosine_schedule",
    "create_train_state",
    "instance_accuracy",
    "make_cls_train_step",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "smooth_cls_loss",
    "step_decay_schedule",
]
