"""Export a trained model's inference as a ``torch.export`` artifact
(counterpart of ``mpa_tpu/cli/export.py``).

Usage:
  python -m mpa_tpu_torch.cli.export --preset scanobjectnn_cls \\
      --checkpoint runs/.../checkpoints --out model.pt2 [--serve_batch 64] [--device cpu]

The artifact is shape-specialised to ``--serve_batch`` clouds of
``--num_points`` points (part-seg with the ``[B, 16]`` category one-hot
beside them) and runs on the device it was exported on (``--device``,
default ``cuda``); load it with ``mpa_tpu_torch.serve.load_inference(path)``,
which needs ``mpa_tpu_torch.ops`` and no model code. Every field of
``TrainConfig`` is a flag over the preset, as in ``cli.train`` and
``cli.eval``. ``--checkpoint`` restores the weights and BatchNorm
statistics only (into an lr-0 SGD state), so a checkpoint of any optimizer
exports; without it a fresh init from the preset's seed is exported. See
``mpa_tpu_torch/serve/export.py`` for the artifact and its manifest.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from mpa_tpu_torch import serve
from mpa_tpu_torch.cli.eval import eval_state
from mpa_tpu_torch.configs import (
    PRESETS, TrainConfig, add_config_flags, resolve_config, resolve_task_model,
)
from mpa_tpu_torch.train.checkpoint import BestCheckpointer
from mpa_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags of ``argv`` (default ``sys.argv[1:]``), with the resolved
    ``TrainConfig`` as ``.config``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_config_flags(ap, TrainConfig())
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="named config preset; explicit flags still override")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory of cli.train (omit to export a fresh init)")
    ap.add_argument("--out", required=True, help="the artifact's path (its manifest: OUT.json)")
    ap.add_argument("--serve_batch", type=int, default=8,
                    help="the clouds of a request the artifact is specialised to")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the device the artifact is traced on and "
                         "serves; a torch artifact runs only there")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    args.config = resolve_task_model(resolve_config(ap, args, argv))
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Export; returns the artifact's manifest fields given by the CLI."""
    args = parse_args(argv)
    cfg = args.config
    if cfg.task not in ("cls", "partseg"):
        raise ValueError(f"cli.export has the cls and part-seg inputs, as mpa_tpu's has; "
                         f"task {cfg.task!r} is not one")
    device = resolve_device(args.device)
    B, N = args.serve_batch, cfg.num_points
    points = torch.zeros((B, N, 3), dtype=torch.float32)
    example = points
    if cfg.task == "partseg":
        example = (points, torch.zeros((B, cfg.num_categories), dtype=torch.float32))
    state = eval_state(cfg, device)
    best = None
    if args.checkpoint:
        restored = BestCheckpointer(args.checkpoint).restore(state, restore_optimizer=False)
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.checkpoint}")
        best = restored[1]
    ep = serve.export_inference(state.model, example, device=device)
    manifest = {"model": cfg.model, "task": cfg.task, "num_points": N, "serve_batch": B,
                "checkpoint": args.checkpoint, "train_best_metric": best}
    serve.save_exported(ep, args.out, manifest=manifest)
    print(f"exported {cfg.model} ({cfg.task}) -> {args.out} "
          f"[batch={B}, n={N}, device={device}]")
    return manifest


if __name__ == "__main__":
    main()
