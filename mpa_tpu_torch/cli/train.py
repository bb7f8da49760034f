"""Training CLI (counterpart of ``mpa_tpu/cli/train.py``): classification,
part segmentation, semantic segmentation, pose regression and shape
completion, on synthetic clouds or on a real dataset.

Usage:
  python -m mpa_tpu_torch.cli.train --preset scanobjectnn_cls --dataset synthetic --max_steps 5
  python -m mpa_tpu_torch.cli.train --preset scanobjectnn_cls --dataset scanobjectnn --data_root R
  python -m mpa_tpu_torch.cli.train --preset modelnet40_cls --dataset modelnet40 --data_root R
  python -m mpa_tpu_torch.cli.train --preset shapenetpart --dataset shapenetpart --data_root R
  python -m mpa_tpu_torch.cli.train --preset shapenetpart --dataset shapenetpart --data_root R \
      --dry_data_check
  python -m mpa_tpu_torch.cli.train --preset s3dis_semseg --num_points 16384 --batch_size 2 \
      --neighbor_mode window_all --max_steps 5
  python -m mpa_tpu_torch.cli.train --preset s3dis_semseg --dataset s3dis --data_root R
  python -m mpa_tpu_torch.cli.train --preset pose_modelnet40 --dataset modelnet40 --data_root R
  python -m mpa_tpu_torch.cli.train --preset completion --max_steps 5
  python -m mpa_tpu_torch.cli.train --device cpu --batch_size 4 --max_steps 2
  python -m mpa_tpu_torch.cli.train --task partseg --scheduler cos --eta_min 1e-3 --init xavier
  python -m mpa_tpu_torch.cli.train --preset shapenetpart --import_torch best_model.pth
  torchrun --nproc_per_node 4 -m mpa_tpu_torch.cli.train --preset shapenetpart --batch_size 128

Every field of ``TrainConfig`` is a flag (``configs.add_config_flags``): the
preset (default ``scanobjectnn_cls``, whose values are ``TrainConfig``'s
defaults) is the base and only the flags given override it, abbreviations
included; a task other than cls with the cls model takes its task's model
(``configs.resolve_task_model``). ``--init xavier|kaiming|zero`` re-draws the
weights after the model is built (``utils/init.py``), then
``--import_torch`` reads a reference ``best_model.pth`` into the cls or
part-seg model (``utils/torch_import.py``; weights only unless
``--trust_torch_pickle``).

Trains the preset's model with the preset's optimizer and schedule. The
batches come through ``data/pipeline.py::prefetch_to_device`` (a thread
builds and pins the next host batches while the card runs a step), each
step's loss stays on the device, and the losses are read once the epoch
ends, with the epoch's seconds and clouds/s. Everything goes to the console
and to ``{log_dir}/{preset}_{dataset}/train.log``, the epochs' and evals'
numbers to ``train_metrics.jsonl`` there (``utils/logging.py``).

Under torchrun (``WORLD_SIZE`` in the environment) the run is data-parallel
(``mpa_tpu_torch/parallel``): one process a rank on ``cuda:LOCAL_RANK``
(NCCL) or on the CPU (gloo); ``--batch_size`` is the global batch, every
rank iterates the same shuffled batches and keeps its rows, BatchNorm
reduces over the global batch and the gradients are averaged before the
optimizer. The augmentation and pose's rotations are drawn for the global
batch, so they equal a one-process run's; each rank draws its dropout masks
from ``seed + rank``. Only rank 0 evaluates, logs and writes checkpoints.

Part segmentation scales (0.8-1.25) and
shifts (+-0.1) every training batch on the device; other tasks do so only
with ``--aug_scale`` / ``--aug_shift``. Pose composes every training batch
with a fresh z-rotation per cloud, applied to the cloud and its target
rotation alike. Those draws depend on the seed and the state's step alone,
so a resumed run draws what an unbroken one would.

Each epoch from ``--min_val_epoch`` on, one cut short by ``--max_steps``
too, ends with an eval pass, and the best state by its metric is kept in
``{log_dir}/{preset}_{dataset}/checkpoints/best`` (``train/checkpoint.py``);
a run resumes from it (weights, optimizer, step). The checkpoints are keyed
by the preset, where ``mpa_tpu`` keys them by the task: two presets of one
task (``scanobjectnn_cls`` and ``scanobjectnn_2x``) would otherwise resume
from each other's checkpoint, which restore refuses. The evals:
classification votes ``num_votes`` passes (``train/votes.py``) and reports
the pool's instance accuracy (vote-acc, the checkpoint's metric), one
pass's (single-acc) and the pool's class-average accuracy; part
segmentation the instance and class mIoU of the category-masked argmax;
semantic segmentation the block mIoU and point accuracy; pose the mean
geodesic error in degrees, completion the Chamfer distance of the fine
cloud, each the mean of the eval batches' means (the checkpoint keeps the
least).

Datasets: ``synthetic`` (classification ``synthetic_clouds(512, seed=0)``
and 128 eval clouds of seed 1; part segmentation ``realistic_partseg`` 256
and 64, composed primitives in the ShapeNetPart label layout; semantic
segmentation ``synthetic_semseg`` blocks, 8 rooms of 24, seed 0, and 2
rooms, seed 100; pose ``realistic_clouds`` 512 and 128 in their canonical
frame, seeds 0 and 1; completion ``synthetic_clouds`` 512 and 128),
``scanobjectnn`` (h5, clouds at their 2048 points, as ``mpa_tpu`` takes
them), ``modelnet40`` (text tree, the first ``num_points`` rows,
normalised; for cls, pose and completion), ``shapenetpart`` (resampled to
``num_points``) and ``s3dis`` (``Area_*.npy`` rooms, 32 blocks drawn from
each training room, 16 from each Area 5 room). Pose rotates each cloud
about z by an angle drawn from ``default_rng(0)`` (train) or ``(1)``
(eval), the rotation its target; completion keeps the half of each cloud
with the lowest x as the input and the whole cloud as the target.
``--dry_data_check`` loads every split through the same loaders, checks
shapes, dtypes and label ranges (part-seg labels inside their category's
block), prints one JSON line and exits 0 or 1 without touching a
device. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from mpa_tpu_torch import parallel
from mpa_tpu_torch.configs import (
    PRESETS,
    TrainConfig,
    add_config_flags,
    model_kwargs,
    resolve_config,
    resolve_task_model,
)
from mpa_tpu_torch.data import augment, s3dis
from mpa_tpu_torch.data.pipeline import batch_iterator, host_shard, prefetch_to_device
from mpa_tpu_torch.data.modelnet import load_modelnet
from mpa_tpu_torch.data.scanobjectnn import load_scanobjectnn
from mpa_tpu_torch.data.shapenetpart import (
    NUM_CATEGORIES,
    NUM_PARTS,
    SEG_PARTS,
    load_split,
    to_categorical,
)
from mpa_tpu_torch.data.synthetic import (
    realistic_clouds,
    realistic_partseg,
    synthetic_clouds,
    synthetic_semseg,
)
from mpa_tpu_torch.models import get_model, rotation_geodesic_loss
from mpa_tpu_torch.train.checkpoint import BestCheckpointer
from mpa_tpu_torch.train.losses import chamfer_distance
from mpa_tpu_torch.train.loop import TRAIN_STEPS, TrainState, create_train_state, make_eval_step
from mpa_tpu_torch.train.metrics import (
    category_masked_argmax,
    class_average_accuracy,
    instance_accuracy,
    part_iou_metrics,
)
from mpa_tpu_torch.train.votes import vote_predict
from mpa_tpu_torch.utils.device import resolve_device
from mpa_tpu_torch.utils.init import apply_weight_init, init_like_flax
from mpa_tpu_torch.utils.logging import ExperimentLogger, make_logger
from mpa_tpu_torch.utils.profiling import count_params, span
from mpa_tpu_torch.utils.torch_import import import_reference_checkpoint

# (train clouds, eval clouds) of the synthetic dataset, per task; for
# semantic segmentation, blocks (24 to a synthetic room).
DATASET_SIZES = {"cls": (512, 128), "partseg": (256, 64), "semseg": (192, 48),
                 "pose": (512, 128), "completion": (512, 128)}
BLOCKS_PER_ROOM = 24
# Blocks drawn from each S3DIS room: (training room, test room).
S3DIS_BLOCKS = (32, 16)
# The datasets each task reads.
DATASETS = {"cls": ("synthetic", "scanobjectnn", "modelnet40"),
            "partseg": ("synthetic", "shapenetpart"), "semseg": ("synthetic", "s3dis"),
            "pose": ("synthetic", "modelnet40"), "completion": ("synthetic", "modelnet40")}
# The eval metric the checkpoint keeps the best of, and its sign: the
# checkpoint keeps the maximum of sign * metric (``mpa_tpu`` returns the
# negatives of pose's and completion's errors for it).
CHECKPOINT_METRIC = {"cls": ("instance_acc", 1), "partseg": ("ins_miou", 1),
                     "semseg": ("block_miou", 1), "pose": ("geodesic_error_deg", -1),
                     "completion": ("chamfer", -1)}
# Random streams of a run, each seeded from (seed, stream, step) by
# ``stream_generator`` (``mpa_tpu`` folds 2, 4 and 99 into its root key for
# the first three, and 2 again for --init's draws).
AUG_STREAM, POSE_STREAM, VOTE_STREAM, INIT_STREAM = 2, 4, 99, 3


def stream_generator(seed: int, stream: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` whose state depends on ``(seed, stream,
    step)`` alone."""
    state = np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def pose_arrays(points: np.ndarray, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each cloud rotated about z by an angle drawn from ``default_rng(seed)``
    (``mpa_tpu/cli/train.py::_pose_arrays``): (rotated xyz ``[B, N, 3]``,
    the rotations ``[B, 3, 3]``), float32."""
    r = np.random.default_rng(seed)
    angles = r.uniform(0, 2 * np.pi, len(points))
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], -1).reshape(
        -1, 3, 3).astype(np.float32)
    rotated = np.einsum("bij,bnj->bni", rot, points[..., :3])
    return rotated.astype(np.float32), rot


def completion_arrays(points: np.ndarray, keep_ratio: float = 0.5
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(partial, full) pairs (``mpa_tpu/cli/train.py::_completion_arrays``):
    the ``keep_ratio`` share of each cloud's points with the lowest x, every
    channel, and the whole cloud's xyz, float32."""
    n_keep = int(points.shape[1] * keep_ratio)
    order = np.argsort(points[..., 0], axis=1)  # crop along x
    partial = np.take_along_axis(points, order[:, :n_keep, None], axis=1)
    return partial.astype(np.float32), points[..., :3].astype(np.float32)


def s3dis_blocks(cfg: TrainConfig, split: str, blocks_per_room: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``blocks_per_room`` blocks of ``cfg.num_points`` points from every room
    of ``split`` under ``cfg.data_root``, each room's drawn from
    ``default_rng(0)`` (``sample_blocks``' default), in room order."""
    rooms = s3dis.list_rooms(cfg.data_root, split=split)
    if not rooms:
        raise ValueError(f"no {split} rooms (Area_*.npy) under {cfg.data_root}")
    feats, labels = [], []
    for room in rooms:
        xyzrgb, lab = s3dis.load_room(room)
        bx, by = s3dis.sample_blocks(xyzrgb, lab, blocks_per_room, cfg.num_points)
        feats.append(bx)
        labels.append(by)
    return np.concatenate(feats), np.concatenate(labels)


def load_dataset(cfg: TrainConfig, n_train: Optional[int] = None, n_eval: Optional[int] = None):
    """``(train arrays, eval arrays)`` of ``cfg.dataset`` for ``cfg.task``:
    ``(points, labels)`` for classification, ``(points, category, per-point
    labels)`` for part segmentation, ``(blocks, per-point labels)`` for
    semantic segmentation, ``(rotated points, rotations)`` for pose and
    ``(partial, full)`` for completion. The synthetic cloud counts default
    to ``DATASET_SIZES``; a real split is cut to ``n_train`` / ``n_eval``
    clouds when they are given (pose and completion cut the clouds before
    they are rotated or cropped)."""
    if cfg.dataset not in DATASETS[cfg.task]:
        raise ValueError(f"dataset {cfg.dataset!r} has no {cfg.task} data; "
                         f"choose from {DATASETS[cfg.task]}")
    if cfg.task in ("pose", "completion"):
        if cfg.dataset == "synthetic":
            n_train = n_train or cfg.synthetic_train_clouds
            n_eval = n_eval or DATASET_SIZES[cfg.task][1]
            # Pose needs clouds in their class's frame: a target rotation on
            # top of an unknown base rotation could not be recovered.
            clouds = (functools.partial(realistic_clouds, canonical_pose=True)
                      if cfg.task == "pose" else synthetic_clouds)
            train = clouds(n_train, cfg.num_points, cfg.num_classes, seed=0)[0]
            test = clouds(n_eval, cfg.num_points, cfg.num_classes, seed=1)[0]
        else:
            if not cfg.data_root:
                raise ValueError(f"dataset {cfg.dataset!r} needs --data_root")
            train = load_modelnet(cfg.data_root, "train", 40, cfg.num_points)[0][:n_train]
            test = load_modelnet(cfg.data_root, "test", 40, cfg.num_points)[0][:n_eval]
        if cfg.task == "pose":
            return pose_arrays(train, 0), pose_arrays(test, 1)
        return completion_arrays(train), completion_arrays(test)
    if cfg.dataset == "synthetic":
        n_train = n_train or DATASET_SIZES[cfg.task][0]
        n_eval = n_eval or DATASET_SIZES[cfg.task][1]
        if cfg.task == "semseg":
            def blocks(n, seed):
                rooms = -(-n // BLOCKS_PER_ROOM)
                return tuple(a[:n] for a in synthetic_semseg(rooms, cfg.num_points, seed=seed))

            return blocks(n_train, 0), blocks(n_eval, 100)
        if cfg.task == "partseg":
            return (realistic_partseg(n_train, cfg.num_points, seed=0),
                    realistic_partseg(n_eval, cfg.num_points, seed=1))
        return (synthetic_clouds(n_train, cfg.num_points, cfg.num_classes, seed=0),
                synthetic_clouds(n_eval, cfg.num_points, cfg.num_classes, seed=1))
    if not cfg.data_root:
        raise ValueError(f"dataset {cfg.dataset!r} needs --data_root")
    root = cfg.data_root
    if cfg.dataset == "s3dis":
        train = s3dis_blocks(cfg, "train", S3DIS_BLOCKS[0])
        test = s3dis_blocks(cfg, "test", S3DIS_BLOCKS[1])
    elif cfg.dataset == "scanobjectnn":
        train, test = load_scanobjectnn(root, "training"), load_scanobjectnn(root, "test")
    elif cfg.dataset == "modelnet40":
        train = load_modelnet(root, "train", 40, cfg.num_points)[:2]
        test = load_modelnet(root, "test", 40, cfg.num_points)[:2]
    else:
        train = load_split(root, "trainval", cfg.num_points)
        test = load_split(root, "test", cfg.num_points)
    return (tuple(a[:n_train] for a in train) if n_train else train,
            tuple(a[:n_eval] for a in test) if n_eval else test)


def host_batch(cfg: TrainConfig, batch: Tuple[np.ndarray, ...]):
    """One host batch as the model takes it, on the host: ``((points,
    category one-hot), labels)`` for part segmentation, ``(inputs,
    targets)`` otherwise."""
    if cfg.task == "partseg":
        pts, cats, segs = batch
        return (pts, to_categorical(cats, cfg.num_categories)), segs
    return tuple(batch)


def make_inputs(cfg: TrainConfig, batch: Tuple[np.ndarray, ...], device: torch.device):
    """One host batch -> ``(model inputs, labels)`` on ``device``."""
    inputs, labels = host_batch(cfg, batch)
    if cfg.task == "partseg":
        inputs = tuple(torch.from_numpy(a).to(device) for a in inputs)
    else:
        inputs = torch.from_numpy(inputs).to(device)
    return inputs, torch.from_numpy(labels).to(device)


def augmentation(cfg: TrainConfig) -> Tuple[bool, bool]:
    """``(scale, shift)``: both for part segmentation, as ``mpa_tpu`` does
    for every part-seg run; for other tasks ``cfg.aug_scale`` /
    ``cfg.aug_shift``."""
    partseg = cfg.task == "partseg"
    return cfg.aug_scale or partseg, cfg.aug_shift or partseg


def _rows(shard: Tuple[int, int], batch: int) -> Tuple[int, slice]:
    """``(global batch, this rank's rows of it)`` for ``shard = (rank,
    ranks)`` and a rank's ``batch`` clouds."""
    rank, ranks = shard
    return ranks * batch, slice(rank * batch, (rank + 1) * batch)


def pose_resample(cfg: TrainConfig, points: torch.Tensor, rotations: torch.Tensor, step: int,
                  shard: Tuple[int, int] = (0, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pose batch of step ``step`` (``mpa_tpu/cli/train.py:470-491``):
    a z-rotation per cloud, its angle uniform in ``[0, 2 pi)`` from
    ``stream_generator(cfg.seed, POSE_STREAM, step)``, applied to the points
    and composed with the target rotations, so that the model never sees one
    cloud with one fixed target. With ``shard = (rank, ranks)`` the angles
    are drawn for the global batch and the rank's rows are taken, so every
    angle is a one-process run's."""
    n, rows = _rows(shard, points.shape[0])
    generator = stream_generator(cfg.seed, POSE_STREAM, step, points.device)
    theta = torch.rand((n,), generator=generator, device=points.device)[rows] * (2.0 * np.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    r2 = torch.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(-1, 3, 3)
    return (torch.einsum("bij,bnj->bni", r2, points),
            torch.einsum("bij,bjk->bik", r2, rotations))


def augment_batch(cfg: TrainConfig, points: torch.Tensor, step: int,
                  shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The train augmentation of step ``step`` on the points' device
    (``mpa_tpu/cli/train.py:455-467``): a per-cloud scale in ``[0.8, 1.25)``,
    then a shift in ``[-0.1, 0.1)`` of every channel, as
    :func:`augmentation` says, drawn from ``stream_generator(cfg.seed,
    AUG_STREAM, step)``; with ``shard``, drawn for the global batch and
    sliced to the rank's rows, as in :func:`pose_resample`."""
    scale, shift = augmentation(cfg)
    if not (scale or shift):
        return points
    with span("train.augment", step):
        n, rows = _rows(shard, points.shape[0])
        generator = stream_generator(cfg.seed, AUG_STREAM, step, points.device)
        if scale:
            points = augment.scale_points(points, augment.draw_scales(generator, n, points)[rows])
        if shift:
            points = augment.shift_points(points, augment.draw_shifts(generator, n, points)[rows])
        return points


def _say(log: Optional[ExperimentLogger], msg: str) -> None:
    if log is None:
        print(msg, flush=True)
    else:
        log.info(msg)


def vote_pass(cfg: TrainConfig, state: TrainState, arrays, device: torch.device,
              num_votes: int, generator: Optional[torch.Generator] = None):
    """``(pool, single)``: the ``num_votes``-vote pool and the clean pass's
    log-probs of every cloud of ``arrays``, in order, on the host; the vote
    scales come from ``generator`` (``train/votes.py``)."""
    eval_step = make_eval_step()
    pools, singles = [], []
    with torch.inference_mode():
        for batch in batch_iterator(arrays, cfg.batch_size, drop_last=False):
            inputs, _ = make_inputs(cfg, batch, device)
            if cfg.task == "partseg":
                points, onehot = inputs
                forward = lambda x: eval_step(state, (x, onehot))  # noqa: E731
            else:
                points, forward = inputs, (lambda x: eval_step(state, x))
            pool, single = vote_predict(forward, points, num_votes, generator=generator)
            pools.append(pool.cpu().numpy())
            singles.append(single.cpu().numpy())
    return np.concatenate(pools), np.concatenate(singles)


def batch_means(cfg: TrainConfig, state: TrainState, test_arrays, device: torch.device,
                metric) -> float:
    """The unweighted mean over the eval batches (the last one ragged) of
    ``metric(model output, targets)``, each batch's a mean over its clouds,
    as ``mpa_tpu`` averages pose's and completion's errors."""
    eval_step = make_eval_step()
    values = []
    with torch.inference_mode():
        for batch in batch_iterator(test_arrays, cfg.batch_size, drop_last=False):
            inputs, targets = make_inputs(cfg, batch, device)
            values.append(float(metric(eval_step(state, inputs), targets)))
    return float(np.mean(values))


def evaluate(cfg: TrainConfig, state: TrainState, test_arrays, device: torch.device,
             log: Optional[ExperimentLogger] = None) -> dict:
    """One eval over the eval clouds: ``instance_acc`` (of the
    ``cfg.num_votes``-vote pool), ``single_acc`` and ``class_acc`` for
    classification, ``ins_miou`` / ``class_miou`` of one pass for part
    segmentation, ``block_miou`` / ``point_acc`` of one pass for semantic
    segmentation, ``geodesic_error_deg`` for pose, ``chamfer`` (of the fine
    cloud) for completion. Every eval of a run draws the same vote
    scales. The result goes to ``log`` (the console without one)."""
    if cfg.task == "pose":
        err = batch_means(cfg, state, test_arrays, device, rotation_geodesic_loss) * 180.0 / np.pi
        _say(log, f"eval after {state.step} steps: mean geodesic error {err:.2f} deg over "
             f"{len(test_arrays[0])} clouds")
        return {"geodesic_error_deg": err}
    if cfg.task == "completion":
        cd = batch_means(cfg, state, test_arrays, device,
                         lambda out, full: chamfer_distance(out[1], full))
        _say(log, f"eval after {state.step} steps: chamfer {cd:.5f} over {len(test_arrays[0])} "
             "clouds")
        return {"chamfer": cd}
    votes = cfg.num_votes if cfg.task == "cls" else 1
    pool, single = vote_pass(cfg, state, test_arrays, device, votes,
                             stream_generator(cfg.seed, VOTE_STREAM, 0, device))
    target = test_arrays[-1]
    if cfg.task == "cls":
        pred = pool.argmax(-1)
        acc = instance_accuracy(pred, target)
        single_acc = instance_accuracy(single.argmax(-1), target)
        cls_acc = class_average_accuracy(pred, target, cfg.num_classes)
        _say(log, f"eval after {state.step} steps ({votes} votes): vote-acc (instance acc) "
             f"{acc:.4f}, single-acc {single_acc:.4f}, class-acc {cls_acc:.4f} over "
             f"{len(target)} clouds")
        return {"instance_acc": acc, "single_acc": single_acc, "class_acc": cls_acc}
    if cfg.task == "semseg":
        miou, acc, _ = s3dis.semseg_iou(pool.argmax(-1).reshape(-1), target.reshape(-1),
                                        cfg.num_classes)
        _say(log, f"eval after {state.step} steps: block-mIoU {miou:.4f}, point acc {acc:.4f} "
             f"over {len(target)} blocks")
        return {"block_miou": miou, "point_acc": acc}
    cats = test_arrays[1]
    preds = list(category_masked_argmax(pool, cats, SEG_PARTS))
    ins, cls_m, _ = part_iou_metrics(preds, list(target), list(cats), SEG_PARTS)
    _say(log, f"eval after {state.step} steps: ins-mIoU {ins:.4f}, class-mIoU {cls_m:.4f} "
         f"over {len(target)} clouds")
    return {"ins_miou": ins, "class_miou": cls_m}


def dry_data_check(cfg: TrainConfig, n_train: Optional[int] = None,
                   n_eval: Optional[int] = None) -> int:
    """Load every split through :func:`load_dataset`, check shapes, dtypes,
    finite points and label ranges (part segmentation: every label inside its
    cloud's category block of ``SEG_PARTS``), print the report and the epoch
    plan as one JSON line, and return the exit code (0: usable). Touches no
    device."""
    report = {"task": cfg.task, "dataset": cfg.dataset, "data_root": cfg.data_root, "ok": False}
    try:
        train_arrays, test_arrays = load_dataset(cfg, n_train, n_eval)
    except (OSError, ValueError, KeyError, ImportError) as e:
        report["error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(report), flush=True)
        return 1
    problems = []
    for split, arrays in (("train", train_arrays), ("test", test_arrays)):
        report[split] = {"clouds": len(arrays[0]), "shapes": [list(a.shape) for a in arrays],
                         "dtypes": [str(a.dtype) for a in arrays]}
        if len(arrays[0]) == 0:
            problems.append(f"{split}: no clouds")
            continue
        if cfg.task == "partseg":
            _, cats, segs = arrays
            if cats.min() < 0 or cats.max() >= NUM_CATEGORIES:
                problems.append(f"{split}: category ids outside [0, {NUM_CATEGORIES})")
            elif segs.min() < 0 or segs.max() >= NUM_PARTS:
                problems.append(f"{split}: part labels outside [0, {NUM_PARTS})")
            else:
                bad = sum(int((~np.isin(segs[cats == c], SEG_PARTS[c])).sum())
                          for c in range(NUM_CATEGORIES))
                if bad:
                    problems.append(f"{split}: {bad} point labels outside their cloud's "
                                    "category part block (SEG_PARTS)")
        elif cfg.task in ("pose", "completion"):
            if not np.isfinite(arrays[1]).all():
                problems.append(f"{split}: non-finite targets")
        else:
            labels = arrays[1]
            if labels.min() < 0 or labels.max() >= cfg.num_classes:
                problems.append(f"{split}: labels outside [0, {cfg.num_classes}) "
                                f"(saw {labels.min()}..{labels.max()})")
        if not np.isfinite(arrays[0]).all():
            problems.append(f"{split}: non-finite point coordinates")
    n = len(train_arrays[0])
    spe = max(1, n // cfg.batch_size)
    report["epoch_plan"] = {"batch_size": cfg.batch_size, "steps_per_epoch": spe,
                            "epochs": cfg.epochs, "total_steps": spe * cfg.epochs,
                            "drop_last_clouds": n - spe * cfg.batch_size
                            if n >= cfg.batch_size else 0}
    report["problems"] = problems
    report["ok"] = not problems
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_flags(ap, TrainConfig())
    ap.add_argument("--preset", default="scanobjectnn_cls", choices=sorted(PRESETS),
                    help="the config the flags given override")
    ap.add_argument("--dry_data_check", action="store_true",
                    help="check the data through the loaders, print one JSON line, exit 0 or 1")
    ap.add_argument("--max_steps", type=int, default=0,
                    help="stop after this many steps of this run (0: all epochs)")
    ap.add_argument("--train_clouds", type=int, default=None,
                    help="synthetic default: 512 (cls; pose and completion: "
                         "--synthetic_train_clouds), 256 (partseg), 192 blocks (semseg); "
                         "a real split: all")
    ap.add_argument("--eval_clouds", type=int, default=None,
                    help="synthetic default: 128 (cls, pose, completion), 64 (partseg), "
                         "48 blocks (semseg); a real split: all")
    ap.add_argument("--device", default=None,
                    help="cuda (default; cuda:LOCAL_RANK under torchrun) or cpu")
    ap.add_argument("--import_torch", default=None,
                    help="a reference best_model.pth to start from (cls or part-seg model)")
    ap.add_argument("--trust_torch_pickle", action="store_true",
                    help="load --import_torch with full unpickling, which runs any code the "
                         "file holds; default: the weights-only loader")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags of ``argv`` (default ``sys.argv[1:]``), with the resolved
    ``TrainConfig`` as ``.config``."""
    ap = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    args.config = resolve_task_model(resolve_config(ap, args, argv))
    return args


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    return args.config


def checkpoint_dir(cfg: TrainConfig, preset: str) -> str:
    return os.path.join(cfg.log_dir, f"{preset}_{cfg.dataset}", "checkpoints")


def build_state(cfg: TrainConfig, device: torch.device, log: ExperimentLogger,
                import_torch: Optional[str] = None, trust_pickle: bool = False) -> TrainState:
    """The config's model with flax's initialisation from ``cfg.seed``, then
    ``cfg.init``'s re-initialisation, then the reference checkpoint
    ``import_torch`` (``mpa_tpu/cli/train.py:391-416``'s order), on
    ``device`` with its optimizer."""
    model = get_model(cfg.model, **model_kwargs(cfg))
    init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
    if cfg.init:
        apply_weight_init(model, cfg.init, stream_generator(cfg.seed, INIT_STREAM, 0,
                                                            torch.device("cpu")))
        log.info(f"re-initialised the weights with --init {cfg.init}")
    if import_torch:
        task = "partseg" if cfg.task == "partseg" else "cls"
        report = import_reference_checkpoint(import_torch, task, model, allow_pickle=trust_pickle)
        log.info(f"imported torch checkpoint {import_torch} "
                 f"({len(report['skipped_torch_keys'])} dead/aux keys skipped)")
    return create_train_state(model, cfg, device)


def _join_torchrun(device: torch.device) -> Tuple[torch.device, bool]:
    """Under torchrun (``WORLD_SIZE`` set, no group yet) join the process
    group: ``(this rank's device, True)``; else ``(device, False)``."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device, False
    return parallel.init(device=device if device.type == "cpu" else None), True


def run(args: argparse.Namespace) -> Tuple[TrainState, dict]:
    """Train as ``args`` say; returns the final state and ``{"steps" (of
    this run), "losses" (one a step, read at each epoch's end),
    "epoch_seconds", "clouds_per_s" (one an epoch, of the global batch),
    "aug_delta"}`` plus the last eval's metrics; ``aug_delta`` is the mean
    ``|augmented - raw|`` of the run's first batch (None when the run does
    not augment). Under a process group (torchrun, or one the caller
    joined) the run is data-parallel, and ranks other than 0 return no
    eval metrics."""
    cfg = config_from_args(args)
    device, joined = _join_torchrun(resolve_device(args.device))
    try:
        return _train(cfg, args, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(cfg: TrainConfig, args: argparse.Namespace, device: torch.device
           ) -> Tuple[TrainState, dict]:
    rank, ranks = parallel.world()
    data_parallel = dist.is_initialized()
    run_dir = os.path.join(cfg.log_dir, f"{args.preset}_{cfg.dataset}")
    with make_logger(run_dir if rank == 0 else None) as log:
        log.info(f"config: {cfg}")
        train_arrays, test_arrays = load_dataset(cfg, args.train_clouds, args.eval_clouds)
        steps_per_epoch = max(1, len(train_arrays[0]) // cfg.batch_size)
        state = build_state(cfg, device, log, args.import_torch, args.trust_torch_pickle)
        if data_parallel:
            state.generator.manual_seed(cfg.seed + rank)  # the rank's dropout masks
            parallel.replicate(parallel.sync_batchnorm(state.model))
            train_step = parallel.make_data_parallel_train_step(cfg, steps_per_epoch)
        else:
            train_step = TRAIN_STEPS[cfg.task](cfg, steps_per_epoch)
        log.info(f"model {cfg.model}: {count_params(state.model) / 1e6:.2f}M params on {device}"
                 f"{f', rank {rank} of {ranks}' if data_parallel else ''}; "
                 f"{steps_per_epoch} steps per epoch")
        ckpt = BestCheckpointer(checkpoint_dir(cfg, args.preset))
        if ckpt.restore(state) is not None:
            log.info(f"resumed from {ckpt.path} at step {state.step} "
                     f"(best {ckpt.best_metric:.4f}); the steps below count this run's")

        shard = (rank, ranks)

        def to_host(batch):  # on the prefetch thread: the rank's rows, as the model takes them
            return host_batch(cfg, host_shard(batch, len(batch[0]), rank, ranks))

        data_rng = np.random.default_rng(cfg.seed)
        losses, seconds, rates, aug_delta, metrics, steps = [], [], [], None, {}, 0
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            epoch_losses = []
            feed = prefetch_to_device(batch_iterator(train_arrays, cfg.batch_size, rng=data_rng),
                                      device, transform=to_host)
            with contextlib.closing(feed):
                for inputs, labels in feed:
                    raw = inputs[0] if cfg.task == "partseg" else inputs
                    if cfg.task == "pose":
                        raw, labels = pose_resample(cfg, raw, labels, state.step, shard)
                    points = augment_batch(cfg, raw, state.step, shard)
                    inputs = (points, inputs[1]) if cfg.task == "partseg" else points
                    epoch_losses.append(train_step(state, inputs, labels))  # stays on the card
                    steps += 1
                    if steps == 1 and any(augmentation(cfg)):
                        aug_delta = (points - raw).abs().mean()  # read once the run ends
                    if args.max_steps and steps >= args.max_steps:
                        break
            if epoch_losses:
                first = steps - len(epoch_losses) + 1
                values = torch.stack(epoch_losses).cpu().tolist()  # waits for the epoch
                dt = time.perf_counter() - t0
                losses += values
                seconds.append(dt)
                rates.append(len(values) * cfg.batch_size / dt)
                for i, loss in enumerate(values):
                    log.info(f"step {first + i} (epoch {epoch}): loss {loss:.4f}")
                log.info(f"epoch {epoch}: loss {np.mean(values):.4f} over {len(values)} steps, "
                         f"{dt:.3f} s, {rates[-1]:.1f} clouds/s")
                log.metrics(state.step, epoch=epoch, train_loss=float(np.mean(values)),
                            seconds=dt, clouds_per_s=rates[-1])
            if epoch >= cfg.min_val_epoch and rank == 0:
                metrics = evaluate(cfg, state, test_arrays, device, log)
                log.metrics(state.step, epoch=epoch, **metrics)
                key, sign = CHECKPOINT_METRIC[cfg.task]
                if ckpt.save_if_best(state, sign * metrics[key]):
                    log.info(f"new best {key} {sign * ckpt.best_metric:.4f} -> {ckpt.path}")
            if args.max_steps and steps >= args.max_steps:
                break
    return state, {"steps": steps, "losses": losses, "epoch_seconds": seconds,
                   "clouds_per_s": rates,
                   "aug_delta": None if aug_delta is None else float(aug_delta), **metrics}


def main(argv: Optional[Sequence[str]] = None) -> Union[dict, int]:
    """Run the trainer and return :func:`run`'s dict; with
    ``--dry_data_check``, the check's exit code."""
    args = parse_args(argv)
    if args.dry_data_check:
        return dry_data_check(config_from_args(args), args.train_clouds, args.eval_clouds)
    return run(args)[1]


if __name__ == "__main__":
    ret = main()
    sys.exit(ret if isinstance(ret, int) else 0)
