"""Training CLI (counterpart of ``mpa_tpu/cli/train.py``): classification,
part segmentation and semantic segmentation, on synthetic clouds or on a
real dataset.

Usage:
  python -m mpa_tpu_torch.cli.train --preset scanobjectnn_cls --dataset synthetic --max_steps 5
  python -m mpa_tpu_torch.cli.train --preset scanobjectnn_cls --dataset scanobjectnn --data_root R
  python -m mpa_tpu_torch.cli.train --preset modelnet40_cls --dataset modelnet40 --data_root R
  python -m mpa_tpu_torch.cli.train --preset shapenetpart --dataset shapenetpart --data_root R
  python -m mpa_tpu_torch.cli.train --preset shapenetpart --dataset shapenetpart --data_root R \
      --dry_data_check
  python -m mpa_tpu_torch.cli.train --preset s3dis_semseg --num_points 16384 --batch_size 2 \
      --neighbor_mode window_all --max_steps 5
  python -m mpa_tpu_torch.cli.train --device cpu --batch_size 4 --max_steps 2

Trains the preset's model with the preset's optimizer and schedule and logs
each step's loss and clouds/s. Part segmentation scales (0.8-1.25) and
shifts (+-0.1) every training batch on the device; other tasks do so only
with ``--aug_scale`` / ``--aug_shift``. Those draws depend on the seed and
the state's step alone, so a resumed run draws what an unbroken one would.

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
semantic segmentation the block mIoU and point accuracy.

Datasets: ``synthetic`` (classification ``synthetic_clouds(512, seed=0)``
and 128 eval clouds of seed 1; part segmentation ``realistic_partseg`` 256
and 64, composed primitives in the ShapeNetPart label layout; semantic
segmentation ``synthetic_semseg`` blocks, 8 rooms of 24, seed 0, and 2
rooms, seed 100), ``scanobjectnn`` (h5, clouds at their 2048 points, as
``mpa_tpu`` takes them), ``modelnet40`` (text tree, the first
``num_points`` rows, normalised) and ``shapenetpart`` (resampled to
``num_points``). ``--dry_data_check`` loads every split through the same
loaders, checks shapes, dtypes and label ranges (part-seg labels inside
their category's block), prints one JSON line and exits 0 or 1 without
touching a device. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mpa_tpu_torch.configs import PRESETS, TrainConfig, model_kwargs
from mpa_tpu_torch.data import augment
from mpa_tpu_torch.data.modelnet import load_modelnet
from mpa_tpu_torch.data.s3dis import semseg_iou
from mpa_tpu_torch.data.scanobjectnn import load_scanobjectnn
from mpa_tpu_torch.data.shapenetpart import (
    NUM_CATEGORIES,
    NUM_PARTS,
    SEG_PARTS,
    load_split,
    to_categorical,
)
from mpa_tpu_torch.data.synthetic import realistic_partseg, synthetic_clouds, synthetic_semseg
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.train.checkpoint import BestCheckpointer
from mpa_tpu_torch.train.loop import TRAIN_STEPS, TrainState, create_train_state, make_eval_step
from mpa_tpu_torch.train.metrics import (
    category_masked_argmax,
    class_average_accuracy,
    instance_accuracy,
    part_iou_metrics,
)
from mpa_tpu_torch.train.votes import vote_predict
from mpa_tpu_torch.utils.device import resolve_device
from mpa_tpu_torch.utils.init import init_like_flax

# (train clouds, eval clouds) of the synthetic dataset, per task; for
# semantic segmentation, blocks (24 to a synthetic room).
DATASET_SIZES = {"cls": (512, 128), "partseg": (256, 64), "semseg": (192, 48)}
BLOCKS_PER_ROOM = 24
# The datasets each task reads.
DATASETS = {"cls": ("synthetic", "scanobjectnn", "modelnet40"),
            "partseg": ("synthetic", "shapenetpart"), "semseg": ("synthetic",)}
# The eval metric whose maximum the checkpoint keeps.
CHECKPOINT_METRIC = {"cls": "instance_acc", "partseg": "ins_miou", "semseg": "block_miou"}
# Random streams of a run, each seeded from (seed, stream, step) by
# ``stream_generator`` (``mpa_tpu`` folds 2 and 99 into its root key for them).
AUG_STREAM, VOTE_STREAM = 2, 99


def stream_generator(seed: int, stream: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` whose state depends on ``(seed, stream,
    step)`` alone."""
    state = np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def batches(
    arrays: Tuple[np.ndarray, ...], batch_size: int,
    rng: Optional[np.random.Generator] = None, drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """``rng=None`` keeps the order (eval); ``drop_last=False`` keeps the
    ragged tail batch."""
    n = len(arrays[0])
    order = rng.permutation(n) if rng is not None else np.arange(n)
    stop = n - n % batch_size if drop_last else n
    for i in range(0, stop, batch_size):
        idx = order[i : i + batch_size]
        yield tuple(a[idx] for a in arrays)


def load_dataset(cfg: TrainConfig, n_train: Optional[int] = None, n_eval: Optional[int] = None):
    """``(train arrays, eval arrays)`` of ``cfg.dataset`` for ``cfg.task``:
    ``(points, labels)`` for classification, ``(points, category, per-point
    labels)`` for part segmentation, ``(blocks, per-point labels)`` for
    semantic segmentation. The synthetic cloud counts default to
    ``DATASET_SIZES``; a real split is cut to ``n_train`` / ``n_eval``
    clouds when they are given."""
    if cfg.dataset not in DATASETS[cfg.task]:
        raise ValueError(f"dataset {cfg.dataset!r} has no {cfg.task} data; "
                         f"choose from {DATASETS[cfg.task]}")
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
    if cfg.dataset == "scanobjectnn":
        train, test = load_scanobjectnn(root, "training"), load_scanobjectnn(root, "test")
    elif cfg.dataset == "modelnet40":
        train = load_modelnet(root, "train", 40, cfg.num_points)[:2]
        test = load_modelnet(root, "test", 40, cfg.num_points)[:2]
    else:
        train = load_split(root, "trainval", cfg.num_points)
        test = load_split(root, "test", cfg.num_points)
    return (tuple(a[:n_train] for a in train) if n_train else train,
            tuple(a[:n_eval] for a in test) if n_eval else test)


def make_inputs(cfg: TrainConfig, batch: Tuple[np.ndarray, ...], device: torch.device):
    """One host batch -> ``(model inputs, labels)`` on ``device``."""
    if cfg.task == "partseg":
        pts, cats, segs = batch
        onehot = to_categorical(cats, cfg.num_categories)
        return ((torch.from_numpy(pts).to(device), torch.from_numpy(onehot).to(device)),
                torch.from_numpy(segs).to(device))
    pts, labels = batch
    return torch.from_numpy(pts).to(device), torch.from_numpy(labels).to(device)


def augmentation(cfg: TrainConfig) -> Tuple[bool, bool]:
    """``(scale, shift)``: both for part segmentation, as ``mpa_tpu`` does
    for every part-seg run; for other tasks ``cfg.aug_scale`` /
    ``cfg.aug_shift``."""
    partseg = cfg.task == "partseg"
    return cfg.aug_scale or partseg, cfg.aug_shift or partseg


def augment_batch(cfg: TrainConfig, points: torch.Tensor, step: int) -> torch.Tensor:
    """The train augmentation of step ``step`` on the points' device
    (``mpa_tpu/cli/train.py:455-467``): a per-cloud scale in ``[0.8, 1.25)``,
    then a shift in ``[-0.1, 0.1)`` of every channel, as
    :func:`augmentation` says, drawn from ``stream_generator(cfg.seed,
    AUG_STREAM, step)``."""
    scale, shift = augmentation(cfg)
    if not (scale or shift):
        return points
    generator = stream_generator(cfg.seed, AUG_STREAM, step, points.device)
    if scale:
        points = augment.random_scale(points, generator)
    if shift:
        points = augment.random_shift(points, generator)
    return points


def vote_pass(cfg: TrainConfig, state: TrainState, arrays, device: torch.device,
              num_votes: int, generator: Optional[torch.Generator] = None):
    """``(pool, single)``: the ``num_votes``-vote pool and the clean pass's
    log-probs of every cloud of ``arrays``, in order, on the host; the vote
    scales come from ``generator`` (``train/votes.py``)."""
    eval_step = make_eval_step()
    pools, singles = [], []
    with torch.inference_mode():
        for batch in batches(arrays, cfg.batch_size, drop_last=False):
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


def evaluate(cfg: TrainConfig, state: TrainState, test_arrays, device: torch.device) -> dict:
    """One eval over the eval clouds: ``instance_acc`` (of the
    ``cfg.num_votes``-vote pool), ``single_acc`` and ``class_acc`` for
    classification, ``ins_miou`` / ``class_miou`` of one pass for part
    segmentation, ``block_miou`` / ``point_acc`` of one pass for semantic
    segmentation. Every eval of a run draws the same vote scales."""
    votes = cfg.num_votes if cfg.task == "cls" else 1
    pool, single = vote_pass(cfg, state, test_arrays, device, votes,
                             stream_generator(cfg.seed, VOTE_STREAM, 0, device))
    target = test_arrays[-1]
    if cfg.task == "cls":
        pred = pool.argmax(-1)
        acc = instance_accuracy(pred, target)
        single_acc = instance_accuracy(single.argmax(-1), target)
        cls_acc = class_average_accuracy(pred, target, cfg.num_classes)
        print(f"eval after {state.step} steps ({votes} votes): vote-acc (instance acc) "
              f"{acc:.4f}, single-acc {single_acc:.4f}, class-acc {cls_acc:.4f} over "
              f"{len(target)} clouds", flush=True)
        return {"instance_acc": acc, "single_acc": single_acc, "class_acc": cls_acc}
    if cfg.task == "semseg":
        miou, acc, _ = semseg_iou(pool.argmax(-1).reshape(-1), target.reshape(-1),
                                  cfg.num_classes)
        print(f"eval after {state.step} steps: block-mIoU {miou:.4f}, point acc {acc:.4f} "
              f"over {len(target)} blocks", flush=True)
        return {"block_miou": miou, "point_acc": acc}
    cats = test_arrays[1]
    preds = list(category_masked_argmax(pool, cats, SEG_PARTS))
    ins, cls_m, _ = part_iou_metrics(preds, list(target), list(cats), SEG_PARTS)
    print(f"eval after {state.step} steps: ins-mIoU {ins:.4f}, class-mIoU {cls_m:.4f} "
          f"over {len(target)} clouds", flush=True)
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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="scanobjectnn_cls", choices=sorted(PRESETS))
    ap.add_argument("--dataset", default=None,
                    choices=["synthetic", "scanobjectnn", "modelnet40", "shapenetpart"],
                    help="default: the preset's (synthetic)")
    ap.add_argument("--data_root", default=None, help="the real dataset's directory")
    ap.add_argument("--dry_data_check", action="store_true",
                    help="check the data through the loaders, print one JSON line, exit 0 or 1")
    ap.add_argument("--log_dir", default=None, help="default: the preset's (runs)")
    ap.add_argument("--max_steps", type=int, default=0,
                    help="stop after this many steps of this run (0: all epochs)")
    ap.add_argument("--batch_size", type=int, default=None, help="default: the preset's")
    ap.add_argument("--num_points", type=int, default=None, help="default: the preset's")
    ap.add_argument("--train_clouds", type=int, default=None,
                    help="synthetic default: 512 (cls), 256 (partseg), 192 blocks (semseg); "
                         "a real split: all")
    ap.add_argument("--eval_clouds", type=int, default=None,
                    help="synthetic default: 128 (cls), 64 (partseg), 48 blocks (semseg); "
                         "a real split: all")
    ap.add_argument("--neighbor_mode", default=None, choices=["exact", "window", "window_all"],
                    help="segmentation neighbour mode; default: the preset's (exact)")
    ap.add_argument("--aug_scale", action="store_true", help="scale every train batch")
    ap.add_argument("--aug_shift", action="store_true", help="shift every train batch")
    ap.add_argument("--num_votes", type=int, default=None,
                    help="vote passes of the cls eval; default: the preset's (3)")
    ap.add_argument("--min_val_epoch", type=int, default=None,
                    help="first epoch that ends with an eval; default: the preset's (0)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=None, help="default: the preset's")
    return ap.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    overrides = {k: getattr(args, k) for k in (
        "batch_size", "num_points", "seed", "neighbor_mode", "dataset", "data_root", "log_dir",
        "num_votes", "min_val_epoch") if getattr(args, k) is not None}
    overrides.update({k: True for k in ("aug_scale", "aug_shift") if getattr(args, k)})
    return PRESETS[args.preset].with_overrides(**overrides)


def checkpoint_dir(cfg: TrainConfig, preset: str) -> str:
    return os.path.join(cfg.log_dir, f"{preset}_{cfg.dataset}", "checkpoints")


def run(args: argparse.Namespace) -> Tuple[TrainState, dict]:
    """Train as ``args`` say; returns the final state and ``{"steps" (of
    this run), "losses", "step_ms", "aug_delta"}`` plus the last eval's
    metrics; ``aug_delta`` is the mean ``|augmented - raw|`` of the run's
    first batch (None when the run does not augment)."""
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    print(f"config: {cfg}", flush=True)

    train_arrays, test_arrays = load_dataset(cfg, args.train_clouds, args.eval_clouds)
    steps_per_epoch = max(1, len(train_arrays[0]) // cfg.batch_size)

    model = get_model(cfg.model, **model_kwargs(cfg))
    init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg, device)
    train_step = TRAIN_STEPS[cfg.task](cfg, steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.model}: {n_params / 1e6:.2f}M params on {device}; "
          f"{steps_per_epoch} steps per epoch", flush=True)
    ckpt = BestCheckpointer(checkpoint_dir(cfg, args.preset))
    if ckpt.restore(state) is not None:
        print(f"resumed from {ckpt.path} at step {state.step} (best {ckpt.best_metric:.4f}); "
              "the steps below count this run's", flush=True)

    data_rng = np.random.default_rng(cfg.seed)
    losses, step_ms, aug_delta, metrics, steps = [], [], None, {}, 0
    for epoch in range(cfg.epochs):
        for batch in batches(train_arrays, cfg.batch_size, data_rng):
            inputs, labels = make_inputs(cfg, batch, device)
            t0 = time.perf_counter()
            raw = inputs[0] if cfg.task == "partseg" else inputs
            points = augment_batch(cfg, raw, state.step)
            inputs = (points, inputs[1]) if cfg.task == "partseg" else points
            loss = float(train_step(state, inputs, labels))  # waits for the step to finish
            dt = time.perf_counter() - t0
            losses.append(loss)
            step_ms.append(dt * 1e3)
            steps += 1
            if steps == 1 and any(augmentation(cfg)):
                aug_delta = (points - raw).abs().mean()  # read once the run ends
            print(f"step {steps} (epoch {epoch}): loss {loss:.4f}, "
                  f"{len(batch[0]) / dt:.1f} clouds/s", flush=True)
            if args.max_steps and steps >= args.max_steps:
                break
        if epoch >= cfg.min_val_epoch:
            metrics = evaluate(cfg, state, test_arrays, device)
            if ckpt.save_if_best(state, metrics[CHECKPOINT_METRIC[cfg.task]]):
                print(f"new best {CHECKPOINT_METRIC[cfg.task]} "
                      f"{ckpt.best_metric:.4f} -> {ckpt.path}", flush=True)
        if args.max_steps and steps >= args.max_steps:
            break
    return state, {"steps": steps, "losses": losses, "step_ms": step_ms,
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
