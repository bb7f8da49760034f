"""Training CLI (counterpart of ``mpa_tpu/cli/train.py``): classification,
part segmentation and semantic segmentation on synthetic data.

Usage:
  python -m mpa_tpu_torch.cli.train --preset scanobjectnn_cls --dataset synthetic --max_steps 5
  python -m mpa_tpu_torch.cli.train --preset shapenetpart --dataset synthetic --max_steps 5
  python -m mpa_tpu_torch.cli.train --preset s3dis_semseg --num_points 16384 --batch_size 2 \
      --neighbor_mode window_all --max_steps 5
  python -m mpa_tpu_torch.cli.train --device cpu --batch_size 4 --max_steps 2

Trains the preset's model with the preset's optimizer and schedule, logs each
step's loss and clouds/s, and after the last step runs one eval pass. A
classification preset trains on ``synthetic_clouds(512, ..., seed=0)`` and
reports instance and class-average accuracy over ``synthetic_clouds(128, ...,
seed=1)``. A part-seg preset trains on ``realistic_partseg(256, ..., seed=0)``
(composed primitives in the ShapeNetPart label layout, ``mpa_tpu``'s
synthetic part-seg data) and reports instance and class mIoU of the
category-masked argmax over ``realistic_partseg(64, ..., seed=1)``. A
semantic-segmentation preset trains on ``synthetic_semseg`` blocks (8 rooms
of 24 blocks, seed 0; ``mpa_tpu``'s synthetic S3DIS rooms) and reports the
block mIoU and point accuracy (``semseg_iou``) over 2 rooms' blocks (seed
100); ``--neighbor_mode`` picks its neighbour mode. Runs on ``cuda`` unless
``--device cpu`` is given. Checkpoints, augmentation, vote TTA
and the real-data loaders are not ported yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from mpa_tpu_torch.configs import PRESETS, TrainConfig, model_kwargs
from mpa_tpu_torch.data.s3dis import semseg_iou
from mpa_tpu_torch.data.shapenetpart import SEG_PARTS, to_categorical
from mpa_tpu_torch.data.synthetic import realistic_partseg, synthetic_clouds, synthetic_semseg
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.train.loop import TRAIN_STEPS, create_train_state, make_eval_step
from mpa_tpu_torch.train.metrics import (
    category_masked_argmax,
    class_average_accuracy,
    instance_accuracy,
    part_iou_metrics,
)
from mpa_tpu_torch.utils.device import resolve_device
from mpa_tpu_torch.utils.init import init_like_flax

# (train clouds, eval clouds) of the synthetic dataset, per task; for
# semantic segmentation, blocks (24 to a synthetic room).
DATASET_SIZES = {"cls": (512, 128), "partseg": (256, 64), "semseg": (192, 48)}
BLOCKS_PER_ROOM = 24


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
    """``(train arrays, eval arrays)`` of the synthetic dataset of
    ``cfg.task``: ``(points, labels)`` for classification, ``(points,
    category, per-point labels)`` for part segmentation, ``(blocks,
    per-point labels)`` for semantic segmentation. The cloud counts default
    to ``DATASET_SIZES``."""
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


def make_inputs(cfg: TrainConfig, batch: Tuple[np.ndarray, ...], device: torch.device):
    """One host batch -> ``(model inputs, labels)`` on ``device``."""
    if cfg.task == "partseg":
        pts, cats, segs = batch
        onehot = to_categorical(cats, cfg.num_categories)
        return ((torch.from_numpy(pts).to(device), torch.from_numpy(onehot).to(device)),
                torch.from_numpy(segs).to(device))
    pts, labels = batch
    return torch.from_numpy(pts).to(device), torch.from_numpy(labels).to(device)


def evaluate(cfg: TrainConfig, state, test_arrays, device: torch.device) -> dict:
    """One pass over the eval clouds: ``instance_acc`` / ``class_acc`` for
    classification, ``ins_miou`` / ``class_miou`` for part segmentation,
    ``block_miou`` / ``point_acc`` for semantic segmentation."""
    eval_step = make_eval_step()
    preds, targets, cats_all = [], [], []
    for batch in batches(test_arrays, cfg.batch_size, drop_last=False):
        inputs, _ = make_inputs(cfg, batch, device)
        logp = eval_step(state, inputs).cpu().numpy()
        if cfg.task == "partseg":
            preds += list(category_masked_argmax(logp, batch[1], SEG_PARTS))
            cats_all += list(batch[1])
        else:
            preds += list(logp.argmax(-1))
        targets += list(batch[-1])
    if cfg.task == "semseg":
        pred = np.concatenate([p.reshape(-1) for p in preds])
        target = np.concatenate([t.reshape(-1) for t in targets])
        miou, acc, _ = semseg_iou(pred, target, cfg.num_classes)
        print(f"eval after {state.step} steps: block-mIoU {miou:.4f}, point acc {acc:.4f} "
              f"over {len(targets)} blocks", flush=True)
        return {"block_miou": miou, "point_acc": acc}
    if cfg.task == "partseg":
        ins, cls_m, _ = part_iou_metrics(preds, targets, cats_all, SEG_PARTS)
        print(f"eval after {state.step} steps: ins-mIoU {ins:.4f}, class-mIoU {cls_m:.4f} "
              f"over {len(targets)} clouds", flush=True)
        return {"ins_miou": ins, "class_miou": cls_m}
    pred, target = np.asarray(preds), np.asarray(targets)
    acc = instance_accuracy(pred, target)
    cls_acc = class_average_accuracy(pred, target, cfg.num_classes)
    print(f"eval after {state.step} steps: instance acc {acc:.4f}, class acc {cls_acc:.4f} "
          f"over {len(target)} clouds", flush=True)
    return {"instance_acc": acc, "class_acc": cls_acc}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="scanobjectnn_cls", choices=sorted(PRESETS))
    ap.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    ap.add_argument("--max_steps", type=int, default=0, help="stop after this many steps (0: all epochs)")
    ap.add_argument("--batch_size", type=int, default=None, help="default: the preset's")
    ap.add_argument("--num_points", type=int, default=None, help="default: the preset's")
    ap.add_argument("--train_clouds", type=int, default=None,
                    help="default: 512 (cls), 256 (partseg), 192 blocks (semseg)")
    ap.add_argument("--eval_clouds", type=int, default=None,
                    help="default: 128 (cls), 64 (partseg), 48 blocks (semseg)")
    ap.add_argument("--neighbor_mode", default=None, choices=["exact", "window", "window_all"],
                    help="segmentation neighbour mode; default: the preset's (exact)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=None, help="default: the preset's")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the trainer; returns ``{"steps", "losses"}`` and the eval metrics
    of :func:`evaluate`."""
    args = parse_args(argv)
    overrides = {k: getattr(args, k) for k in ("batch_size", "num_points", "seed", "neighbor_mode")
                 if getattr(args, k) is not None}
    cfg = PRESETS[args.preset].with_overrides(**overrides)
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

    data_rng = np.random.default_rng(cfg.seed)
    losses = []
    for epoch in range(cfg.epochs):
        for batch in batches(train_arrays, cfg.batch_size, data_rng):
            inputs, labels = make_inputs(cfg, batch, device)
            t0 = time.perf_counter()
            loss = float(train_step(state, inputs, labels))  # waits for the step to finish
            dt = time.perf_counter() - t0
            losses.append(loss)
            print(f"step {state.step} (epoch {epoch}): loss {loss:.4f}, "
                  f"{len(batch[0]) / dt:.1f} clouds/s", flush=True)
            if args.max_steps and state.step >= args.max_steps:
                break
        if args.max_steps and state.step >= args.max_steps:
            break

    return {"steps": state.step, "losses": losses, **evaluate(cfg, state, test_arrays, device)}


if __name__ == "__main__":
    main()
