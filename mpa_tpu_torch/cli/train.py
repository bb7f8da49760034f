"""Training CLI (counterpart of ``mpa_tpu/cli/train.py``), classification on
synthetic clouds.

Usage:
  python -m mpa_tpu_torch.cli.train --preset scanobjectnn_cls --dataset synthetic --max_steps 5
  python -m mpa_tpu_torch.cli.train --device cpu --batch_size 4 --max_steps 2

Trains the preset's model on ``synthetic_clouds(512, ..., seed=0)`` with the
preset's optimizer and schedule, logs each step's loss and clouds/s, and
after the last step runs one eval pass over ``synthetic_clouds(128, ...,
seed=1)`` and reports instance and class-average accuracy. Runs on ``cuda``
unless ``--device cpu`` is given. Checkpoints, vote TTA and the real-data
loaders are not ported yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from mpa_tpu_torch.configs import PRESETS
from mpa_tpu_torch.data.synthetic import synthetic_clouds
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.train.loop import (
    create_train_state,
    make_cls_train_step,
    make_eval_step,
)
from mpa_tpu_torch.train.metrics import class_average_accuracy, instance_accuracy
from mpa_tpu_torch.utils.device import resolve_device
from mpa_tpu_torch.utils.init import init_like_flax

TRAIN_CLOUDS, EVAL_CLOUDS = 512, 128


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


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="scanobjectnn_cls", choices=sorted(PRESETS))
    ap.add_argument("--dataset", default="synthetic", choices=["synthetic"])
    ap.add_argument("--max_steps", type=int, default=0, help="stop after this many steps (0: all epochs)")
    ap.add_argument("--batch_size", type=int, default=None, help="default: the preset's")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=None, help="default: the preset's")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the trainer; returns ``{"steps", "losses", "instance_acc",
    "class_acc"}``."""
    args = parse_args(argv)
    overrides = {k: getattr(args, k) for k in ("batch_size", "seed") if getattr(args, k) is not None}
    cfg = PRESETS[args.preset].with_overrides(**overrides)
    device = resolve_device(args.device)
    print(f"config: {cfg}", flush=True)

    train_arrays = synthetic_clouds(TRAIN_CLOUDS, cfg.num_points, cfg.num_classes, seed=0)
    test_arrays = synthetic_clouds(EVAL_CLOUDS, cfg.num_points, cfg.num_classes, seed=1)
    steps_per_epoch = max(1, TRAIN_CLOUDS // cfg.batch_size)

    model = get_model(cfg.model, num_classes=cfg.num_classes)
    init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
    state = create_train_state(model, cfg, device)
    train_step = make_cls_train_step(cfg, steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model {cfg.model}: {n_params / 1e6:.2f}M params on {device}; "
          f"{steps_per_epoch} steps per epoch", flush=True)

    data_rng = np.random.default_rng(cfg.seed)
    losses = []
    for epoch in range(cfg.epochs):
        for pts, labels in batches(train_arrays, cfg.batch_size, data_rng):
            x = torch.from_numpy(pts).to(device)
            y = torch.from_numpy(labels).to(device)
            t0 = time.perf_counter()
            loss = float(train_step(state, x, y))  # waits for the step to finish
            dt = time.perf_counter() - t0
            losses.append(loss)
            print(f"step {state.step} (epoch {epoch}): loss {loss:.4f}, "
                  f"{len(pts) / dt:.1f} clouds/s", flush=True)
            if args.max_steps and state.step >= args.max_steps:
                break
        if args.max_steps and state.step >= args.max_steps:
            break

    eval_step = make_eval_step()
    preds, targets = [], []
    for pts, labels in batches(test_arrays, cfg.batch_size, drop_last=False):
        logp = eval_step(state, torch.from_numpy(pts).to(device))
        preds.append(logp.argmax(-1).cpu().numpy())
        targets.append(labels)
    pred, target = np.concatenate(preds), np.concatenate(targets)
    acc = instance_accuracy(pred, target)
    cls_acc = class_average_accuracy(pred, target, cfg.num_classes)
    print(f"eval after {state.step} steps: instance acc {acc:.4f}, class acc {cls_acc:.4f} "
          f"over {len(target)} clouds", flush=True)
    return {"steps": state.step, "losses": losses, "instance_acc": acc, "class_acc": cls_acc}


if __name__ == "__main__":
    main()
