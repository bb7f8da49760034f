"""Evaluation CLI (counterpart of ``mpa_tpu/cli/eval.py``): the published
eval protocols of a trained checkpoint.

Usage:
  python -m mpa_tpu_torch.cli.eval --preset modelnet40_cls --dataset modelnet40 --data_root R \
      --checkpoint runs/modelnet40_cls_modelnet40/checkpoints --num_votes 3 --num_repeat 2
  python -m mpa_tpu_torch.cli.eval --preset scanobjectnn_cls --dataset scanobjectnn \
      --data_root R --checkpoint C --num_repeat 50 --num_votes 10
  python -m mpa_tpu_torch.cli.eval --preset shapenetpart --dataset shapenetpart --data_root R \
      --checkpoint C
  python -m mpa_tpu_torch.cli.eval --preset shapenetpart_fp --dataset shapenetpart --data_root R \
      --checkpoint C

Classification (tool/test_classification.py:114-162): ``num_repeat`` times,
a ``num_votes``-vote pass over the test split, fresh vote scales for every
batch and repeat (vote 0 clean, later votes scale xyz per cloud and axis by
0.95-1.05, the pool the mean of the log-probs); the best repeat's vote
accuracy, with its single-pass and class-average accuracy. Part
segmentation (``shapenetpart`` and ``shapenetpart_fp``)
(tool/test_partseg.py:70-221): one vote pass, the argmax over each shape's
category parts, then per-category and instance mIoU, point accuracy and
per-part accuracy, in the reference's ``eval.txt`` lines (written to
``{log_dir}/eval_{preset}_{dataset}/eval.txt`` too).
``--replicate_argmax_quirk`` reproduces tool/test_partseg.py:158, whose
category-local argmax is compared with global labels, for replays of the
published numbers only.

Every field of ``TrainConfig`` is a flag over the preset, as in
``cli.train`` (``configs.resolve_config``, then the task-default model).
``--checkpoint`` is a directory of ``cli.train``'s checkpoints; its weights
and BatchNorm statistics go into an eval state whose optimizer is lr-0 SGD.
``--import_torch`` reads a reference ``best_model.pth`` instead
(``utils/torch_import.py``; weights only unless ``--trust_torch_pickle``).
Without either a fresh init from the preset's seed is evaluated, and the run
says so. The lines go to the console and to ``eval.log`` beside
``eval.txt``. The eval runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import List, Optional, Sequence

import torch

from mpa_tpu_torch.cli.train import load_dataset, vote_pass
from mpa_tpu_torch.configs import (
    PRESETS,
    TrainConfig,
    add_config_flags,
    model_kwargs,
    resolve_config,
    resolve_task_model,
)
from mpa_tpu_torch.data.shapenetpart import CATEGORIES, SEG_PARTS
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.train.checkpoint import BestCheckpointer
from mpa_tpu_torch.train.loop import TrainState, make_optimizer
from mpa_tpu_torch.train.metrics import (
    category_masked_argmax,
    class_avg_point_accuracy,
    class_average_accuracy,
    instance_accuracy,
    part_iou_metrics,
    point_accuracy,
)
from mpa_tpu_torch.utils.device import resolve_device
from mpa_tpu_torch.utils.init import init_like_flax
from mpa_tpu_torch.utils.logging import ExperimentLogger, make_logger
from mpa_tpu_torch.utils.torch_import import import_reference_checkpoint

# Seeds of the vote scales: repeat r of the cls eval draws from
# ``CLS_VOTE_SEED + r``, the part-seg eval from ``PARTSEG_VOTE_SEED``
# (``mpa_tpu`` keys them as ``key(1000 + r)`` and ``key(7)``).
CLS_VOTE_SEED, PARTSEG_VOTE_SEED = 1000, 7


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags of ``argv`` (default ``sys.argv[1:]``), with the resolved
    ``TrainConfig`` as ``.config``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_flags(ap, TrainConfig())
    ap.add_argument("--preset", default="scanobjectnn_cls", choices=sorted(PRESETS),
                    help="the config the flags given override")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory of cli.train (default: a fresh init)")
    ap.add_argument("--import_torch", default=None,
                    help="a reference best_model.pth to evaluate (cls or part-seg model)")
    ap.add_argument("--trust_torch_pickle", action="store_true",
                    help="load --import_torch with full unpickling, which runs any code the "
                         "file holds; default: the weights-only loader")
    ap.add_argument("--num_repeat", type=int, default=1,
                    help="cls: vote passes whose best is reported (50 for the published number)")
    ap.add_argument("--replicate_argmax_quirk", action="store_true",
                    help="part-seg: the reference's category-local argmax compared with global "
                         "labels (tool/test_partseg.py:158); not a correct evaluation")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    args.config = resolve_task_model(resolve_config(ap, args, argv))
    return args


def eval_state(cfg: TrainConfig, device: torch.device) -> TrainState:
    """The preset's model, initialised from its seed, on ``device`` with an
    lr-0 SGD optimizer, in eval mode."""
    model = get_model(cfg.model, **model_kwargs(cfg))
    init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
    model.to(device).eval()
    return TrainState(model, make_optimizer("sgd", model.parameters(), 0.0))


def eval_dir(cfg: TrainConfig, preset: str) -> str:
    return os.path.join(cfg.log_dir, f"eval_{preset}_{cfg.dataset}")


def _write_report(cfg: TrainConfig, preset: str, lines: List[str],
                  log: ExperimentLogger) -> None:
    with open(os.path.join(eval_dir(cfg, preset), "eval.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines:
        log.info(line)


def eval_cls(cfg: TrainConfig, state: TrainState, test_arrays, device: torch.device,
             num_repeat: int) -> dict:
    """The best of ``num_repeat`` vote passes, each with fresh vote scales."""
    target = test_arrays[1]
    best = {"vote_acc": -1.0}
    seconds, lines = [], []
    for rep in range(num_repeat):
        generator = torch.Generator(device=device).manual_seed(CLS_VOTE_SEED + rep)
        t0 = time.perf_counter()  # the pass ends with its results on the host
        pool, single = vote_pass(cfg, state, test_arrays, device, cfg.num_votes, generator)
        seconds.append(time.perf_counter() - t0)
        pred = pool.argmax(-1)
        acc = instance_accuracy(pred, target)
        if acc > best["vote_acc"]:
            best = {"vote_acc": acc,
                    "single_acc": instance_accuracy(single.argmax(-1), target),
                    "class_acc": class_average_accuracy(pred, target, cfg.num_classes)}
        lines.append(f"repeat {rep}: vote-acc {acc:.4f} (best {best['vote_acc']:.4f})")
    lines.append(f"BEST of {num_repeat}: vote-acc {best['vote_acc']:.4f} single-acc "
                 f"{best['single_acc']:.4f} class-acc {best['class_acc']:.4f}")
    return dict(best, pass_seconds=seconds, lines=lines)


def eval_partseg(cfg: TrainConfig, state: TrainState, test_arrays, device: torch.device,
                 quirk: bool) -> dict:
    """One vote pass, the category-masked argmax, the reference's metrics."""
    generator = torch.Generator(device=device).manual_seed(PARTSEG_VOTE_SEED)
    t0 = time.perf_counter()
    pool, _ = vote_pass(cfg, state, test_arrays, device, cfg.num_votes, generator)
    seconds = time.perf_counter() - t0
    _, cats, segs = test_arrays
    preds = list(category_masked_argmax(pool, cats, SEG_PARTS, replicate_offset_quirk=quirk))
    targets, categories = list(segs), list(cats)
    ins, cls_m, cat_map = part_iou_metrics(preds, targets, categories, SEG_PARTS)
    acc = point_accuracy(preds, targets)
    cls_acc = class_avg_point_accuracy(preds, targets, SEG_PARTS)
    # Field for field the reference's eval.txt (log/part_seg/res/eval.txt:4-23).
    lines = [f"eval mIoU of {CATEGORIES[c]:<14s} {iou:.6f}" for c, iou in sorted(cat_map.items())]
    lines += [f"Accuracy is: {acc:.5f}", f"Class avg accuracy is: {cls_acc:.5f}",
              f"Class avg mIOU is: {cls_m:.5f}", f"Inctance avg mIOU is: {ins:.5f}"]
    return {"ins_miou": ins, "class_miou": cls_m, "point_acc": acc, "class_acc": cls_acc,
            "pass_seconds": [seconds], "lines": lines}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the eval; returns its metrics (cls: ``vote_acc``, ``single_acc``,
    ``class_acc`` of the best repeat; part-seg: ``ins_miou``, ``class_miou``,
    ``point_acc``, ``class_acc``), the wall seconds of each vote pass
    (``pass_seconds``) and the clouds evaluated."""
    args = parse_args(argv)
    cfg = args.config
    if cfg.task not in ("cls", "partseg"):
        raise ValueError(f"cli.eval has the cls and part-seg protocols, as mpa_tpu's has; "
                         f"{args.preset!r} is a {cfg.task!r} preset (its metric is cli.train's "
                         "eval)")
    device = resolve_device(args.device)
    with make_logger(eval_dir(cfg, args.preset), "eval") as log:
        _, test_arrays = load_dataset(cfg)
        state = eval_state(cfg, device)
        if args.import_torch:
            report = import_reference_checkpoint(args.import_torch, cfg.task, state.model,
                                                 allow_pickle=args.trust_torch_pickle)
            log.info(f"imported torch checkpoint {args.import_torch} "
                     f"({len(report['skipped_torch_keys'])} dead/aux keys skipped)")
        elif args.checkpoint:
            restored = BestCheckpointer(args.checkpoint).restore(state, restore_optimizer=False)
            if restored is None:
                raise SystemExit(f"no checkpoint under {args.checkpoint}")
            log.info(f"loaded {args.checkpoint} (step {state.step}, train-best metric "
                     f"{restored[1]:.4f})")
        else:
            log.info("no --checkpoint given: evaluating a fresh init")
        if cfg.task == "cls":
            out = eval_cls(cfg, state, test_arrays, device, args.num_repeat)
        else:
            out = eval_partseg(cfg, state, test_arrays, device, args.replicate_argmax_quirk)
        _write_report(cfg, args.preset, out.pop("lines"), log)
        out["clouds"] = len(test_arrays[0])
        log.info(f"{cfg.num_votes} votes x {out['clouds']} clouds a pass; pass seconds "
                 f"{out['pass_seconds']}, median {statistics.median(out['pass_seconds']):.3f}")
    return out


if __name__ == "__main__":
    main()
