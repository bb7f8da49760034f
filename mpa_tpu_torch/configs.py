"""Training configuration and presets (the fields of
``mpa_tpu/utils/config.py::TrainConfig`` that the ported paths read, and
the presets of ``mpa_tpu/configs/presets.py``, all eight of them).

A preset trains on ``synthetic`` clouds unless ``dataset`` names a real one
(``cli.train --dataset ... --data_root ...``); ``mpa_tpu``'s presets name
their real dataset instead, which no test or smoke run here has."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    task: str = "cls"  # 'cls' | 'partseg' | 'semseg' | 'pose' | 'completion'
    model: str = "markov_cls"
    num_classes: int = 15
    num_parts: int = 50  # part-seg: global part labels
    num_categories: int = 16  # part-seg: shape categories
    num_points: int = 1024
    batch_size: int = 64
    # 'synthetic' | 'scanobjectnn' | 'modelnet40' | 'shapenetpart' | 's3dis'
    # (cli/train.py load_dataset)
    dataset: str = "synthetic"
    data_root: Optional[str] = None
    # segmentation: 'exact' (reference semantics) | 'window' (Morton-window
    # spatial neighbourhoods) | 'window_all' (feature kNN and FPS banded too)
    neighbor_mode: str = "exact"
    # window_all: a scale bands its FPS when every band keeps >= fps_min_band
    # points and gives >= fps_min_samples samples (ops/fps.py pick_fps_bands)
    fps_min_band: int = 512
    fps_min_samples: int = 64
    # optimisation (reference cls defaults: Adam 1e-3 / wd 1e-4 / StepLR 20x0.7)
    optimizer: str = "adam-l2"  # 'adam-l2' | 'sgd'
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    momentum: float = 0.9
    scheduler: str = "step"  # 'step' (decay_step, decay_gamma) | 'cos' (epochs, eta_min)
    decay_step: int = 20
    decay_gamma: float = 0.7
    eta_min: float = 0.0
    epochs: int = 300
    label_smoothing: float = 0.1
    # train augmentation: per-cloud scale 0.8-1.25 and shift +-0.1 of every
    # channel; part segmentation always takes both (cli/train.py augment_batch)
    aug_scale: bool = False
    aug_shift: bool = False
    # eval: vote passes of the cls eval (train/votes.py), first epoch evaluated
    num_votes: int = 3
    min_val_epoch: int = 0
    seed: int = 2800
    log_dir: str = "runs"  # checkpoints under {log_dir}/{preset}_{dataset}/checkpoints

    def with_overrides(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def model_kwargs(cfg: TrainConfig) -> dict:
    """The constructor arguments of ``cfg.model`` that ``cfg`` fixes. A
    segmentation ladder halves the cloud four times (1024/512/256/128 at the
    part-seg presets' 2048 points, 2048/1024/512/256 at the semseg preset's
    4096), as ``mpa_tpu/cli/train.py`` scales it for every part-seg model:
    ``markov_partseg_fp`` too, whose own default ladder has five levels.
    Pose and completion take their models' defaults."""
    if cfg.task in ("partseg", "semseg"):
        kw = dict(npoints=tuple(cfg.num_points // 2 ** (i + 1) for i in range(4)),
                  neighbor_mode=cfg.neighbor_mode, fps_min_band=cfg.fps_min_band,
                  fps_min_samples=cfg.fps_min_samples)
        if cfg.task == "semseg":
            return dict(num_classes=cfg.num_classes, **kw)
        return dict(num_parts=cfg.num_parts, num_categories=cfg.num_categories, **kw)
    if cfg.task == "cls":
        return dict(num_classes=cfg.num_classes)
    if cfg.task in ("pose", "completion"):
        return {}
    raise ValueError(f"unknown task {cfg.task}")


PRESETS = {
    # ScanObjectNN classification (published 86.20% OA), 1024-point clouds:
    # batch 64, Adam 1e-3 / wd 1e-4, StepLR 20 x 0.7, 300 epochs, seed 2800.
    "scanobjectnn_cls": TrainConfig(
        model="markov_cls", num_classes=15, num_points=1024, batch_size=64,
        optimizer="adam-l2", learning_rate=1e-3, weight_decay=1e-4,
        decay_step=20, decay_gamma=0.7,
        epochs=300, seed=2800, num_votes=3,
    ),
    # ModelNet40 classification, 1024-point clouds, 40 classes: the cls recipe.
    "modelnet40_cls": TrainConfig(
        model="markov_cls", num_classes=40, num_points=1024, batch_size=64,
        optimizer="adam-l2", learning_rate=1e-3, weight_decay=1e-4,
        decay_step=20, decay_gamma=0.7,
        epochs=300, seed=2800, num_votes=3,
    ),
    # RepSurf-SSG-2x (the umbrella-surface baseline at doubled widths) on
    # ScanObjectNN, 1024-point clouds, 15 classes: the cls recipe, 250 epochs.
    "scanobjectnn_2x": TrainConfig(
        model="repsurf_ssg_2x", num_classes=15, num_points=1024, batch_size=64,
        optimizer="adam-l2", learning_rate=1e-3, weight_decay=1e-4,
        decay_step=20, decay_gamma=0.7,
        epochs=250, seed=2800, num_votes=3,
    ),
    # ShapeNetPart part segmentation (published 86.76% ins-mIoU), 2048-point
    # clouds, 16 categories / 50 parts: batch 32, SGD 0.1 / momentum 0.9 /
    # wd 1e-4, cosine to 1e-3 over 300 epochs, seed 2800, scale and shift
    # augmentation.
    "shapenetpart": TrainConfig(
        task="partseg", model="markov_partseg", num_parts=50, num_categories=16,
        num_points=2048, batch_size=32,
        optimizer="sgd", learning_rate=0.1, weight_decay=1e-4, momentum=0.9,
        scheduler="cos", eta_min=1e-3, epochs=300, seed=2800,
        aug_scale=True, aug_shift=True,
    ),
    # The alternative part-seg model, its feature-propagation decoder
    # (markov_partseg_fp), under the shapenetpart recipe.
    "shapenetpart_fp": TrainConfig(
        task="partseg", model="markov_partseg_fp", num_parts=50, num_categories=16,
        num_points=2048, batch_size=32,
        optimizer="sgd", learning_rate=0.1, weight_decay=1e-4, momentum=0.9,
        scheduler="cos", eta_min=1e-3, epochs=300, seed=2800,
        aug_scale=True, aug_shift=True,
    ),
    # S3DIS semantic segmentation, 4096-point blocks with 9 features, 13
    # classes: batch 16, SGD 0.1 / momentum 0.9 / wd 1e-4, cosine to 1e-3
    # over 100 epochs, seed 2800. The large-scene window modes are
    # ``neighbor_mode`` overrides.
    "s3dis_semseg": TrainConfig(
        task="semseg", model="markov_semseg", num_classes=13, num_points=4096,
        batch_size=16, optimizer="sgd", learning_rate=0.1, weight_decay=1e-4, momentum=0.9,
        scheduler="cos", eta_min=1e-3, epochs=100, seed=2800,
    ),
    # Pose regression over the cls encoder (a 6D rotation, the geodesic
    # loss), 1024-point clouds: batch 64, adam-l2 1e-3 / wd 1e-4, cosine to
    # 1e-5 over 200 epochs, seed 2800.
    "pose_modelnet40": TrainConfig(
        task="pose", model="markov_pose", num_points=1024, batch_size=64,
        optimizer="adam-l2", learning_rate=1e-3, weight_decay=1e-4,
        scheduler="cos", eta_min=1e-5, epochs=200, seed=2800,
    ),
    # Shape completion (coarse FC decoder, folding refinement; Chamfer loss)
    # of half-clouds cut from 1024-point clouds: the pose recipe.
    "completion": TrainConfig(
        task="completion", model="markov_completion", num_points=1024, batch_size=64,
        optimizer="adam-l2", learning_rate=1e-3, weight_decay=1e-4,
        scheduler="cos", eta_min=1e-5, epochs=200, seed=2800,
    ),
}
