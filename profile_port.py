#!/usr/bin/env python3
"""Where a serving request's or a train step's time goes, on the card.

    python3 profile_port.py [--batch 64] [--requests 5] [--trace trace.json]
    python3 profile_port.py --train [--batch 64] [--requests 5]

Loads the ``scanobjectnn_cls`` classifier of the PyTorch port on ``cuda``
(random weights, seed 0), answers two warm-up requests, then traces
``--requests`` requests of ``--batch`` clouds x 1024 points with
``torch.profiler`` and prints: the host wall time per request, the device's
busy share of that wall time (the union of kernel intervals), and device
time per request grouped by kind (the port's kernels, matrix products,
everything else) and by kernel name. With ``--train`` the unit is the
preset's train step (adam-l2, dropout 0.5, train-mode BatchNorm) on
synthetic clouds instead of a request. Needs a CUDA card; exits non-zero
without one.
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
PORT_KERNELS = ("knn_kernel", "fps_kernel", "gather_rows_kernel",
                "transition_attention_fwd_kernel", "scatter_add_rows_kernel",
                "transition_attention_bwd_kernel")


def kind(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return "matmul (cuBLAS)"
    return "other PyTorch kernels"


def make_requests(batch: int):
    """``run(i)`` answers the i-th request of ``batch`` random clouds."""
    from mpa_tpu_torch.serve import load_classifier

    clf = load_classifier("scanobjectnn_cls", seed=0)
    rng = np.random.default_rng(0)
    reqs = {}

    def run(i: int):
        if i not in reqs:
            reqs[i] = torch.from_numpy(
                rng.standard_normal((batch, 1024, 3)).astype(np.float32)).cuda()
        return clf(reqs[i])

    return run


def make_train_steps(batch: int):
    """``run(i)`` takes the preset's train step on the i-th batch of
    synthetic clouds."""
    from mpa_tpu_torch.configs import PRESETS
    from mpa_tpu_torch.data.synthetic import synthetic_clouds
    from mpa_tpu_torch.models import get_model
    from mpa_tpu_torch.train import create_train_state, make_cls_train_step
    from mpa_tpu_torch.utils.init import init_like_flax

    cfg = PRESETS["scanobjectnn_cls"].with_overrides(seed=0)
    pts, labels = synthetic_clouds(512, 1024, cfg.num_classes, seed=0)
    model = init_like_flax(get_model(cfg.model, num_classes=cfg.num_classes),
                           torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, torch.device("cuda"))
    step = make_cls_train_step(cfg, len(pts) // batch)

    def run(i: int):
        sl = slice((i * batch) % len(pts), (i * batch) % len(pts) + batch)
        return step(state, torch.from_numpy(pts[sl]).cuda(), torch.from_numpy(labels[sl]).cuda())

    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--train", action="store_true", help="profile train steps, not requests")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    run = make_train_steps(args.batch) if args.train else make_requests(args.batch)
    for i in range(2):
        run(i)
    torch.cuda.synchronize()

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
    print(f"batch {args.batch} x 1024 points, {n} traced {unit}s")
    print(f"wall per {unit} (profiler on): {wall_ms:.3f} ms")
    print(f"device busy per {unit}: {busy / 1e3 / n:.3f} ms "
          f"({100 * busy / 1e3 / n / wall_ms:.1f}% of wall); "
          f"kernels per {unit}: {len(kernels) / n:.1f}")
    for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {k:36s} {v:8.3f} ms")
    print(f"top kernels by device time per {unit}:")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {v:8.3f} ms  x{count[name] / n:5.1f}  {name[:110]}")
    print(json.dumps({"unit": unit, "wall_ms": wall_ms, "busy_ms": busy / 1e3 / n,
                      "by_kind_ms": dict(by_kind), "kernels_per_unit": len(kernels) / n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
