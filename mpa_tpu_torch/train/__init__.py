"""Training: losses, schedules, the train and eval steps, metrics, vote
test-time augmentation and the best-metric checkpointer."""

from mpa_tpu_torch.train.checkpoint import BestCheckpointer
from mpa_tpu_torch.train.losses import (
    chamfer_distance,
    cls_loss,
    completion_loss,
    mi_aux_loss,
    smooth_cls_loss,
    smooth_seg_loss,
)
from mpa_tpu_torch.train.loop import (
    TRAIN_STEPS,
    TrainState,
    create_train_state,
    make_cls_train_step,
    make_eval_step,
    make_optimizer,
    make_completion_train_step,
    make_partseg_train_step,
    make_pose_train_step,
    make_schedule,
    make_semseg_train_step,
    make_train_step,
)
from mpa_tpu_torch.train.metrics import (
    category_masked_argmax,
    class_avg_point_accuracy,
    class_average_accuracy,
    instance_accuracy,
    part_iou_metrics,
    point_accuracy,
)
from mpa_tpu_torch.train.schedules import cosine_schedule, step_decay_schedule
from mpa_tpu_torch.train.votes import draw_vote_scales, scale_point_cloud, vote_predict

__all__ = [
    "BestCheckpointer",
    "TRAIN_STEPS",
    "TrainState",
    "category_masked_argmax",
    "chamfer_distance",
    "class_avg_point_accuracy",
    "class_average_accuracy",
    "cls_loss",
    "completion_loss",
    "cosine_schedule",
    "create_train_state",
    "draw_vote_scales",
    "instance_accuracy",
    "make_cls_train_step",
    "make_completion_train_step",
    "make_eval_step",
    "make_optimizer",
    "make_partseg_train_step",
    "make_pose_train_step",
    "make_schedule",
    "make_semseg_train_step",
    "make_train_step",
    "mi_aux_loss",
    "part_iou_metrics",
    "point_accuracy",
    "scale_point_cloud",
    "smooth_cls_loss",
    "smooth_seg_loss",
    "step_decay_schedule",
    "vote_predict",
]
