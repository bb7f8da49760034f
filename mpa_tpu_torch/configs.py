"""Training configuration, its command-line flags and the presets.

``TrainConfig`` has every field of ``mpa_tpu/utils/config.py::TrainConfig``
with the same name and default, and the port's own ``num_parts`` and
``num_categories``. ``mesh_axes`` is a no-op here: ``mpa_tpu`` names the
axes of its device mesh with it, while the port's data-parallel world is
the ``torch.distributed`` process group (``mpa_tpu_torch/parallel``).
``steps_per_epoch`` is a no-op too, as in ``mpa_tpu``, which declares it
and never reads it: ``cli.train`` always derives the schedule's epoch as
``max(1, n_train // batch_size)``.

:func:`add_config_flags`, :func:`config_from_args`,
:func:`explicitly_passed` and :func:`resolve_config` behave as
``mpa_tpu``'s do: every field is a ``--flag`` (but the tuple
``mesh_axes``), a preset supplies the base and only the flags given on the
command line override it, prefix abbreviations included. A boolean flag
takes a value (``--aug_scale true``) or none (``--aug_scale``).
:func:`resolve_task_model` is ``mpa_tpu/cli/train.py``'s task-default model
resolution.

A preset trains on ``synthetic`` clouds unless ``dataset`` names a real one
(``cli.train --dataset ... --data_root ...``); ``mpa_tpu``'s presets name
their real dataset instead, which no test or smoke run here has."""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing
from typing import Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    task: str = "cls"  # 'cls' | 'partseg' | 'semseg' | 'pose' | 'completion'
    model: str = "markov_cls"
    num_classes: int = 15
    num_parts: int = 50  # part-seg: global part labels
    num_categories: int = 16  # part-seg: shape categories
    num_points: int = 1024
    # segmentation: 'exact' (reference semantics) | 'window' (Morton-window
    # spatial neighbourhoods) | 'window_all' (feature kNN and FPS banded too)
    neighbor_mode: str = "exact"
    # window_all: a scale bands its FPS when every band keeps >= fps_min_band
    # points and gives >= fps_min_samples samples (ops/fps.py pick_fps_bands)
    fps_min_band: int = 512
    fps_min_samples: int = 64
    # 'synthetic' | 'scanobjectnn' | 'modelnet40' | 'shapenetpart' | 's3dis'
    # (cli/train.py load_dataset)
    dataset: str = "synthetic"
    data_root: Optional[str] = None
    batch_size: int = 64  # the global batch: data-parallel ranks take equal shares
    # pose / completion: synthetic training clouds (the eval split stays 128)
    synthetic_train_clouds: int = 512
    # optimisation (reference cls defaults: Adam 1e-3 / wd 1e-4 / StepLR 20x0.7)
    optimizer: str = "adam-l2"  # 'adam-l2' | 'sgd'
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    momentum: float = 0.9
    scheduler: str = "step"  # 'step' (decay_step, decay_gamma) | 'cos' (epochs, eta_min)
    decay_step: int = 20
    decay_gamma: float = 0.7
    eta_min: float = 1e-3
    epochs: int = 300
    label_smoothing: float = 0.1
    # train augmentation: per-cloud scale 0.8-1.25 and shift +-0.1 of every
    # channel; part segmentation always takes both (cli/train.py augment_batch)
    aug_scale: bool = False
    aug_shift: bool = False
    # eval: vote passes of the cls eval (train/votes.py), first epoch evaluated
    num_votes: int = 3
    min_val_epoch: int = 0
    # weight re-init after the model is built: '' (flax's defaults) |
    # 'xavier' | 'kaiming' | 'zero' (utils/init.py apply_weight_init)
    init: str = ""
    seed: int = 2800
    log_dir: str = "runs"  # logs and checkpoints under {log_dir}/{preset}_{dataset}
    mesh_axes: Tuple[str, ...] = ("data",)  # no-op: the world is the process group
    steps_per_epoch: Optional[int] = None  # no-op: cli.train derives it from the data

    def with_overrides(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def _parse_bool(text: str) -> bool:
    return text.lower() in ("1", "true", "yes")


def _field_type(f: dataclasses.Field):
    """The scalar type of field ``f``: ``Optional[X]`` gives X."""
    hint = typing.get_type_hints(TrainConfig)[f.name]
    args = [a for a in typing.get_args(hint) if a is not type(None)]
    return args[0] if typing.get_origin(hint) is typing.Union else hint


def add_config_flags(parser: argparse.ArgumentParser, config: TrainConfig = TrainConfig()
                     ) -> None:
    """Register every field of ``config`` as a ``--flag`` whose default is
    its value; tuple fields (``mesh_axes``) stay code-level."""
    for f in dataclasses.fields(config):
        default, typ = getattr(config, f.name), _field_type(f)
        if typ is bool:
            parser.add_argument(f"--{f.name}", type=_parse_bool, nargs="?", const=True,
                                default=default)
        elif typing.get_origin(typ) is tuple:
            continue
        else:
            parser.add_argument(f"--{f.name}", type=typ, default=default)


def config_from_args(args: argparse.Namespace, base: Optional[TrainConfig] = None
                     ) -> TrainConfig:
    """``base`` (default ``TrainConfig()``) with every field ``args`` has."""
    base = base or TrainConfig()
    return base.with_overrides(**{f.name: getattr(args, f.name)
                                  for f in dataclasses.fields(base) if hasattr(args, f.name)})


def explicitly_passed(parser: argparse.ArgumentParser, argv: Sequence[str]) -> Set[str]:
    """The dests given on the command line ``argv``: ``argv`` parsed again by
    a parser with ``parser``'s options whose defaults are all ``SUPPRESS``,
    so that argparse resolves prefix abbreviations (``--num_point``) as it
    did for ``parser``."""
    aux = argparse.ArgumentParser(add_help=False)
    for action in parser._actions:
        if not action.option_strings or isinstance(action, argparse._HelpAction):
            continue
        if action.nargs == 0:  # store_true / store_false / count
            aux.add_argument(*action.option_strings, dest=action.dest, action="store_const",
                             const=True, default=argparse.SUPPRESS)
        else:
            aux.add_argument(*action.option_strings, dest=action.dest, nargs=action.nargs,
                             default=argparse.SUPPRESS)
    ns, _ = aux.parse_known_args(list(argv))
    return set(vars(ns))


def resolve_config(parser: argparse.ArgumentParser, args: argparse.Namespace,
                   argv: Optional[Sequence[str]] = None) -> TrainConfig:
    """The config of ``args``: with ``args.preset``, that preset with only
    the explicitly passed flags of ``argv`` (default ``sys.argv[1:]``) over
    it; without, :func:`config_from_args`."""
    argv = sys.argv[1:] if argv is None else argv
    if getattr(args, "preset", None):
        base = PRESETS[args.preset]
        passed = explicitly_passed(parser, argv)
        return base.with_overrides(**{f.name: getattr(args, f.name)
                                      for f in dataclasses.fields(base)
                                      if f.name in passed and hasattr(args, f.name)})
    return config_from_args(args)


# The model of each task when a config names a task but keeps the cls model
# (``mpa_tpu/cli/train.py:310-327``).
TASK_MODELS = {"partseg": "markov_partseg", "semseg": "markov_semseg", "pose": "markov_pose",
               "completion": "markov_completion"}


def resolve_task_model(cfg: TrainConfig) -> TrainConfig:
    """``mpa_tpu``'s task-default resolution: a config of a task other than
    cls that still names ``markov_cls`` takes the task's model; part-seg
    then trains with SGD 0.1 and the cosine schedule, at 2048 points on a
    real dataset, and semseg has 13 classes on S3DIS, 3 on synthetic
    blocks."""
    if cfg.model != "markov_cls" or cfg.task == "cls":
        return cfg
    cfg = cfg.with_overrides(model=TASK_MODELS[cfg.task])
    if cfg.task == "partseg":
        cfg = cfg.with_overrides(optimizer="sgd", learning_rate=0.1, scheduler="cos",
                                 num_points=2048 if cfg.dataset != "synthetic"
                                 else cfg.num_points)
    if cfg.task == "semseg":
        cfg = cfg.with_overrides(num_classes=13 if cfg.dataset == "s3dis" else 3)
    return cfg


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
# The S3DIS recipe in the large-scene mode: 16384-point blocks, every kNN,
# attention and upsample inside its row's Morton window and the encoder's FPS
# banded; the ladder 8192/4096/2048/1024 admits a window at every scale pair.
PRESETS["s3dis_semseg_window_all"] = PRESETS["s3dis_semseg"].with_overrides(
    num_points=16384, neighbor_mode="window_all")
