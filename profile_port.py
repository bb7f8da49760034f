#!/usr/bin/env python3
"""Where a serving request's or a train step's time goes, on the card.

    python3 profile_port.py [--model cls|partseg|semseg|repsurf] [--batch B] [--requests 5] [--trace t.json]
    python3 profile_port.py [--model cls|partseg|semseg|repsurf] --train [--batch B] [--requests 5]

Loads the model's preset of the PyTorch port on ``cuda`` (``scanobjectnn_cls``
at 1024 points, batch 64; ``shapenetpart`` at 2048 points, batch 32;
``s3dis_semseg`` in the ``window_all`` mode at 16384 points, batch 2; or
``scanobjectnn_2x``, ``repsurf_ssg_2x`` at 1024 points, batch 64; random
weights, seed 0), answers two warm-up requests, then traces ``--requests``
requests of ``--batch`` clouds with ``torch.profiler`` and prints: the host
wall time per request, the device's busy share of that wall time (the union
of kernel intervals), and device time per request grouped by kind (the port's
kernels, matrix products, everything else) and by kernel name, and the
peak of allocated device memory. With
``--train`` the unit is the preset's train step (its optimizer, dropout 0.5,
train-mode BatchNorm) on the training CLI's synthetic clouds instead of a
request. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# The windowed names first: "knn_kernel" and "scatter_mean_kernel" are
# parts of theirs.
PORT_KERNELS = ("windowed_knn_kernel", "windowed_attention_fwd_kernel",
                "windowed_attention_bwd_kernel", "windowed_scatter_mean_kernel",
                "knn_kernel", "fps_kernel", "gather_rows_kernel",
                "transition_attention_fwd_kernel", "scatter_add_rows_kernel",
                "transition_attention_bwd_kernel", "scatter_mean_kernel", "ball_query_kernel")
PRESETS = {"cls": "scanobjectnn_cls", "partseg": "shapenetpart", "semseg": "s3dis_semseg",
           "repsurf": "scanobjectnn_2x"}
# Preset fields each model is profiled with, beyond the preset's own.
OVERRIDES = {"semseg": dict(num_points=16384, batch_size=2, neighbor_mode="window_all")}


def kind(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul (cuBLAS)"
    return "other PyTorch kernels"


def make_requests(model: str, batch: int, points: int):
    """``run(i)`` answers the i-th request of ``batch`` clouds: random ones
    for the classifier, ``surface_clouds`` for repsurf (its balls hold
    neighbours on the surface), ``realistic_partseg`` ones with their categories for the
    segmenter, ``synthetic_semseg`` blocks for semseg."""
    from mpa_tpu_torch.data import realistic_partseg, surface_clouds, synthetic_semseg
    from mpa_tpu_torch.serve import load_classifier, load_segmenter, load_semantic_segmenter

    rng = np.random.default_rng(0)
    reqs = {}
    if model == "semseg":
        serve = load_semantic_segmenter(PRESETS[model], seed=0, **OVERRIDES[model])
        blocks = synthetic_semseg(1, points, seed=0)[0]  # 24 blocks, made before any trace

        def make(i):
            lo = (i * batch) % (len(blocks) - batch + 1)
            return (torch.from_numpy(blocks[lo:lo + batch]).cuda(),)
    elif model == "repsurf":
        serve = load_classifier(PRESETS[model], seed=0)

        def make(i):
            return (torch.from_numpy(surface_clouds(batch, points, seed=i)[0]).cuda(),)
    elif model == "partseg":
        serve = load_segmenter(PRESETS[model], seed=0)

        def make(i):
            pts, cats, _ = realistic_partseg(batch, points, seed=i)
            return torch.from_numpy(pts).cuda(), torch.from_numpy(cats).cuda()
    else:
        serve = load_classifier(PRESETS[model], seed=0)

        def make(i):
            return (torch.from_numpy(
                rng.standard_normal((batch, points, 3)).astype(np.float32)).cuda(),)

    def run(i: int):
        if i not in reqs:
            reqs[i] = make(i)
        return serve(*reqs[i])

    return run


def make_train_steps(model: str, batch: int):
    """``run(i)`` takes the preset's train step on the i-th batch of the
    training CLI's synthetic clouds (for repsurf, ``surface_clouds`` as its
    requests)."""
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.configs import PRESETS as CONFIGS, model_kwargs
    from mpa_tpu_torch.data import surface_clouds
    from mpa_tpu_torch.models import get_model
    from mpa_tpu_torch.train import TRAIN_STEPS, create_train_state
    from mpa_tpu_torch.utils.init import init_like_flax

    cfg = CONFIGS[PRESETS[model]].with_overrides(seed=0, **OVERRIDES.get(model, {}))
    if model == "repsurf":
        arrays = surface_clouds(cli_train.DATASET_SIZES["cls"][0], cfg.num_points, cfg.num_classes)
    else:
        arrays, _ = cli_train.load_dataset(cfg, n_eval=1)
    net = init_like_flax(get_model(cfg.model, **model_kwargs(cfg)),
                         torch.Generator().manual_seed(0))
    cuda = torch.device("cuda")
    state = create_train_state(net, cfg, cuda)
    step = TRAIN_STEPS[cfg.task](cfg, len(arrays[0]) // batch)

    def run(i: int):
        lo = (i * batch) % (len(arrays[0]) - batch + 1)
        return step(state, *cli_train.make_inputs(cfg, tuple(a[lo:lo + batch] for a in arrays),
                                                  cuda))

    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="cls", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=None, help="default: the preset's")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--train", action="store_true", help="profile train steps, not requests")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from mpa_tpu_torch.configs import PRESETS as CONFIGS

    cfg = CONFIGS[PRESETS[args.model]].with_overrides(**OVERRIDES.get(args.model, {}))
    batch, points = args.batch or cfg.batch_size, cfg.num_points
    run = (make_train_steps(args.model, batch) if args.train
           else make_requests(args.model, batch, points))
    for i in range(2):
        run(i)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.requests):
            run(2 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    # Device events, less the spans that annotate a region (the optimizer's
    # step), which overlap the kernels inside them.
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    n = args.requests
    by_kind, by_name, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3  # us -> ms
        by_kind[kind(e.name)] += dur / n
        by_name[e.name] += dur / n
        count[e.name] += 1
    wall_ms = wall * 1e3 / n
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    unit = "train step" if args.train else "request"
    print(f"{cfg.model}: batch {batch} x {points} points, {n} traced {unit}s")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"wall per {unit} (profiler on): {wall_ms:.3f} ms; peak allocated {peak_gb:.2f} GB")
    print(f"device busy per {unit}: {busy / 1e3 / n:.3f} ms "
          f"({100 * busy / 1e3 / n / wall_ms:.1f}% of wall); "
          f"kernels per {unit}: {len(kernels) / n:.1f}")
    for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k:36s} {v:8.3f} ms")
    print(f"top kernels by device time per {unit}:")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {v:8.3f} ms  x{count[name] / n:5.1f}  {name[:110]}")
    print(json.dumps({"model": cfg.model, "unit": unit, "wall_ms": wall_ms, "busy_ms": busy / 1e3 / n,
                      "by_kind_ms": dict(by_kind), "kernels_per_unit": len(kernels) / n,
                      "peak_allocated_gb": peak_gb}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
