"""Training: losses, schedules, the train and eval steps, metrics."""

from mpa_tpu_torch.train.losses import cls_loss, smooth_cls_loss, smooth_seg_loss
from mpa_tpu_torch.train.loop import (
    TRAIN_STEPS,
    TrainState,
    create_train_state,
    make_cls_train_step,
    make_eval_step,
    make_optimizer,
    make_partseg_train_step,
    make_schedule,
    make_semseg_train_step,
    make_train_step,
)
from mpa_tpu_torch.train.metrics import (
    category_masked_argmax,
    class_average_accuracy,
    instance_accuracy,
    part_iou_metrics,
)
from mpa_tpu_torch.train.schedules import cosine_schedule, step_decay_schedule

__all__ = [
    "TRAIN_STEPS",
    "TrainState",
    "category_masked_argmax",
    "class_average_accuracy",
    "cls_loss",
    "cosine_schedule",
    "create_train_state",
    "instance_accuracy",
    "make_cls_train_step",
    "make_eval_step",
    "make_optimizer",
    "make_partseg_train_step",
    "make_schedule",
    "make_semseg_train_step",
    "make_train_step",
    "part_iou_metrics",
    "smooth_cls_loss",
    "smooth_seg_loss",
    "step_decay_schedule",
]
