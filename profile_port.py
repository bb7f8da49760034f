#!/usr/bin/env python3
"""Where a serving request's or a train step's time goes, on the card.

    python3 profile_port.py [--model MODEL] [--batch B] [--requests 5] [--trace t.json]
    python3 profile_port.py [--model MODEL] --train [--batch B] [--requests 5]
    python3 profile_port.py --model cls|partseg --bf16 [--train]
    python3 profile_port.py --model partseg --neighbor_mode window|window_all [--bf16] [--train]
    python3 profile_port.py [--model MODEL] [--bf16] --exported

Loads the model's preset of the PyTorch port on ``cuda`` (``scanobjectnn_cls``
at 1024 points, batch 64; ``shapenetpart`` at 2048 points, batch 32;
``s3dis_semseg`` in the ``window_all`` mode at 16384 points, batch 2; or
``scanobjectnn_2x``, ``repsurf_ssg_2x`` at 1024 points, batch 64; random
weights, seed 0; MODEL one of cls, partseg, semseg, repsurf, or
``partseg_fp``, ``pose``, ``completion``: ``shapenetpart_fp`` at 2048
points, batch 32, ``pose_modelnet40`` at 1024 and ``completion`` on
512-point partial clouds, batch 64, on the training CLI's eval clouds, or
``dgcnn``: ``scanobjectnn_cls`` with ``--model dgcnn``, 1024 points, batch
64),
answers two warm-up requests, then traces ``--requests``
requests of ``--batch`` clouds with ``torch.profiler`` and prints: the host
wall time per request, the device's busy share of that wall time (the union
of kernel intervals), and device time per request grouped by kind (the port's
kernels, matrix products, everything else:
``mpa_tpu_torch.utils.profiling.category_breakdown``) and by kernel name
(``op_breakdown``), and the peak of allocated device memory. With
``--train`` the unit is the preset's train step (its optimizer, dropout 0.5,
train-mode BatchNorm) on the training CLI's synthetic clouds instead of a
request. ``--bf16`` builds ``markov_cls`` or ``markov_partseg`` with
``compute_dtype=torch.bfloat16``; ``--neighbor_mode`` builds
``markov_partseg`` in that Morton-window mode. ``--exported`` answers the
requests through the model's exported program (``serve.export_inference``
on the first request, saved and loaded back with ``load_inference``)
instead of the eager loader, so that the host share of the two can be
compared. Every traced request's clouds are made, and the request answered
once, before the trace. The program's spans are on while it is traced, so
``--trace`` shows its layers (``serve.request``, ``train.step``,
``block.*``; ``mpa_tpu_torch/utils/profiling.py``) beside the kernels.
Needs a CUDA card; exits non-zero without one.

    python3 profile_port.py --kernels [--bf16] [--names a,b] [--inputs PATH] [--against DIR ...]

Times ``knn_kernel``, ``windowed_knn_kernel``, ``fps_kernel``,
``transition_attention_fwd_kernel``, ``windowed_attention_fwd_kernel``,
``scatter_mean_kernel``, ``windowed_scatter_mean_kernel``,
``ball_query_kernel``, ``gather_rows_kernel``,
``transition_attention_bwd_kernel``, ``windowed_attention_bwd_kernel`` and
``scatter_add_rows_kernel`` launch by launch on the inputs the main paths
give them (the forward kernels' launches of a request, and the gathers of
a train step too, the scatter-means' backward among them): one served request
of cls, part-seg, repsurf and semseg ``window_all``, one train step of cls,
part-seg, repsurf and semseg ``window_all``, and the FPS over 16384 points and the
exact kNNs of one semseg ``window`` request at 16384 points are recorded,
saved, and every recorded launch is timed (``chip_smoke.time_graph``) in a
subprocess that imports ``mpa_tpu_torch`` from a given root. ``--against``
names checkouts of other commits (for example one unpacked with ``git
archive`` into ``_checkout/``, or a copy of a tree with one part of a
kernel cut out, which splits that kernel's time among its parts); each is
timed twice, in turns with this tree (others, this, this, others in
reverse), all in one run on one card. ``--names`` times only the kernels it
lists; ``--inputs PATH`` keeps the recording there and reuses it when it
exists, so that two runs share it. With ``--bf16`` the recording is the
bf16 launches of a request and a train step of ``markov_cls`` and
``markov_partseg`` with ``compute_dtype=torch.bfloat16`` instead. Prints a per-launch table and the sums
per path, and writes them to ``chiprun_out/kernel_times.json`` (``--out``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PRESETS = {"cls": "scanobjectnn_cls", "partseg": "shapenetpart", "semseg": "s3dis_semseg",
           "repsurf": "scanobjectnn_2x", "partseg_fp": "shapenetpart_fp",
           "pose": "pose_modelnet40", "completion": "completion", "dgcnn": "scanobjectnn_cls"}
# Preset fields each model is profiled with, beyond the preset's own.
OVERRIDES = {"semseg": dict(num_points=16384, batch_size=2, neighbor_mode="window_all"),
             "dgcnn": dict(model="dgcnn")}


TIMED = ("knn_kernel", "windowed_knn_kernel", "fps_kernel", "transition_attention_fwd_kernel",
         "windowed_attention_fwd_kernel", "scatter_mean_kernel", "windowed_scatter_mean_kernel",
         "ball_query_kernel", "gather_rows_kernel", "transition_attention_bwd_kernel",
         "windowed_attention_bwd_kernel", "scatter_add_rows_kernel")
# Forward kernels a train step launches at its request's shapes: timed on
# the request only.
REQUEST_ONLY = ("fps_kernel", "windowed_knn_kernel", "transition_attention_fwd_kernel",
                "windowed_attention_fwd_kernel", "scatter_mean_kernel",
                "windowed_scatter_mean_kernel", "ball_query_kernel")


def exported_program(serve, make):
    """``serve``'s model exported on the card (``serve.export_inference``,
    on the first request), saved and loaded back with ``load_inference``:
    ``(infer, make)``, the loaded program and requests as it takes them
    (the category one-hot of part-seg made with the request)."""
    import tempfile

    from mpa_tpu_torch.serve import export_inference, load_inference, save_exported

    def inputs(i):
        args = make(i)
        if len(args) == 1:
            return (args[0],)
        onehot = torch.nn.functional.one_hot(args[1].long(), serve.model.num_categories)
        return ((args[0], onehot.float()),)

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "program.pt2")
        save_exported(export_inference(serve.model, inputs(0)[0]), path)
        return load_inference(path), inputs


def make_requests(model: str, batch: int, points: int, dtype_kw: dict, exported: bool = False):
    """``run(i)`` answers the i-th request of ``batch`` clouds: random ones
    for the classifier, ``surface_clouds`` for repsurf (its balls hold
    neighbours on the surface), ``realistic_partseg`` ones with their categories for the
    segmenters, ``synthetic_semseg`` blocks for semseg, the training CLI's
    eval clouds for pose and completion (one batch, answered again). With
    ``exported``, through the model's exported program
    (:func:`exported_program`) instead of the eager loader."""
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.data import realistic_partseg, surface_clouds, synthetic_semseg
    from mpa_tpu_torch.serve import (
        load_classifier, load_completer, load_pose_regressor, load_segmenter,
        load_semantic_segmenter,
    )

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
    elif model in ("pose", "completion"):
        serve = (load_pose_regressor if model == "pose" else load_completer)(PRESETS[model], seed=0)
        clouds = torch.from_numpy(cli_train.load_dataset(load_cfg(model), n_train=1,
                                                         n_eval=batch)[1][0]).cuda()

        def make(i):
            return (clouds,)
    elif model in ("partseg", "partseg_fp"):
        serve = load_segmenter(PRESETS[model], seed=0, **OVERRIDES.get(model, {}), **dtype_kw)

        def make(i):
            pts, cats, _ = realistic_partseg(batch, points, seed=i)
            return torch.from_numpy(pts).cuda(), torch.from_numpy(cats).cuda()
    else:
        serve = load_classifier(PRESETS[model], seed=0, **OVERRIDES.get(model, {}), **dtype_kw)

        def make(i):
            return (torch.from_numpy(
                rng.standard_normal((batch, points, 3)).astype(np.float32)).cuda(),)

    if exported:
        serve, make = exported_program(serve, make)

    def run(i: int):
        if i not in reqs:
            reqs[i] = make(i)
        return serve(*reqs[i])

    return run


def make_train_steps(model: str, batch: int, dtype_kw: dict):
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
    net = init_like_flax(get_model(cfg.model, **model_kwargs(cfg), **dtype_kw),
                         torch.Generator().manual_seed(0))
    cuda = torch.device("cuda")
    state = create_train_state(net, cfg, cuda)
    step = TRAIN_STEPS[cfg.task](cfg, len(arrays[0]) // batch)

    def run(i: int):
        lo = (i * batch) % (len(arrays[0]) - batch + 1)
        return step(state, *cli_train.make_inputs(cfg, tuple(a[lo:lo + batch] for a in arrays),
                                                  cuda))

    return run


def record_kernel_inputs(path: Path, bf16: bool = False) -> None:
    """Record the ``TIMED`` launches of one served request of each model, one
    train step of cls, part-seg, repsurf and semseg, and the FPS over 16384
    points and the exact kNNs of one semseg ``window`` request at 16384
    points, and save them to ``path`` as ``[(path, name, inputs)]`` (a window spec as its
    fields). With ``bf16``, instead the bf16 launches of a request and a
    step of cls and part-seg with ``compute_dtype=torch.bfloat16``."""
    from mpa_tpu_torch import kernels

    runs = [("cls", False), ("cls", True), ("partseg", False), ("partseg", True),
            ("repsurf", False), ("repsurf", True), ("semseg", False), ("semseg", True),
            ("semseg_window", False)]
    dtype_kw = {}
    if bf16:
        runs, dtype_kw = runs[:4], {"compute_dtype": torch.bfloat16}
    out = []
    for model, train in runs:
        if model == "semseg_window":
            run = make_window_request()
        else:
            cfg = load_cfg(model)
            run = (make_train_steps(model, cfg.batch_size, dtype_kw) if train
                   else make_requests(model, cfg.batch_size, cfg.num_points, dtype_kw))
        run(0)
        torch.cuda.synchronize()
        kernels.recorded = []
        run(1)
        torch.cuda.synchronize()
        recorded, kernels.recorded = kernels.recorded, None
        for name, inp in recorded:
            if name not in TIMED or (model == "semseg_window" and name not in (
                    "fps_kernel", "knn_kernel")):
                continue
            if model == "semseg_window" and name == "fps_kernel" and inp["points"].shape[1] < 16384:
                continue
            if train and name in REQUEST_ONLY:
                continue
            if bf16 and not any(torch.is_tensor(v) and v.dtype == torch.bfloat16
                                for v in inp.values()):
                continue
            inp = {k: v.detach().clone() if torch.is_tensor(v) else v for k, v in inp.items()}
            if "spec" in inp:
                sp = inp["spec"]
                inp["spec"] = (sp.S, sp.N, sp.sq, sp.bn, sp.n_chunks)
            out.append((model + ("_bf16" if bf16 else "") + ("_train" if train else ""), name,
                        inp))
        del run
        torch.cuda.empty_cache()
    torch.save(out, path)


def make_window_request():
    """``run(i)`` answers one ``markov_semseg`` request in the ``window``
    mode at 16384 points, B = 2 ``synthetic_semseg`` blocks: exact FPS over
    16384 points and exact feature kNNs."""
    from mpa_tpu_torch.data import synthetic_semseg
    from mpa_tpu_torch.serve import load_semantic_segmenter

    serve = load_semantic_segmenter(PRESETS["semseg"], seed=0, num_points=16384,
                                    neighbor_mode="window")
    blocks = synthetic_semseg(1, 16384, seed=0)[0]
    return lambda i: serve(torch.from_numpy(blocks[2 * i:2 * i + 2]).cuda())


def fps_start(inp: dict):
    """A recorded FPS launch's start: an int where every cloud starts at the
    same index (every checkout's ``fps_cuda`` takes one), else the ``[B]``
    tensor."""
    start = inp["start"] if "start" in inp else inp["start_idx"]
    if torch.is_tensor(start) and bool((start == start[0]).all()):
        return int(start[0])
    return start


def time_saved(path: Path, names) -> list:
    """Each saved launch of a kernel in ``names`` timed with the
    ``mpa_tpu_torch`` first on ``sys.path``: median device ms of a CUDA
    graph of 20 calls (None for the others)."""
    import chip_smoke
    from mpa_tpu_torch.ops.attention import attention_bwd_cuda, attention_cuda
    from mpa_tpu_torch.ops.ball_query import ball_query_cuda
    from mpa_tpu_torch.ops.fps import fps_cuda
    from mpa_tpu_torch.ops.gather import gather_cuda, scatter_add_cuda
    from mpa_tpu_torch.ops.knn import knn_cuda
    from mpa_tpu_torch.ops.scatter import scatter_mean_cuda
    from mpa_tpu_torch.ops.window import (
        WindowSpec, windowed_attention_bwd_cuda, windowed_attention_cuda, windowed_knn_cuda,
        windowed_scatter_mean_cuda,
    )

    times = []
    for _, name, inp in torch.load(path, weights_only=False):
        if name not in names:
            times.append(None)
            continue
        inp = {k: v.cuda() if torch.is_tensor(v) else v for k, v in inp.items()}
        if "spec" in inp:
            inp["spec"] = WindowSpec(*inp["spec"])
        if name == "knn_kernel":
            fn = lambda: knn_cuda(inp["k"], inp["base"], inp["query"])  # noqa: E731
        elif name == "windowed_knn_kernel":
            fn = lambda: windowed_knn_cuda(inp["k"], inp["base"], inp["query"],  # noqa: E731
                                           inp["spec"])
        elif name == "fps_kernel":
            start = fps_start(inp)
            fn = lambda: fps_cuda(inp["points"], inp["npoint"], start)  # noqa: E731
        elif name == "transition_attention_fwd_kernel":
            fn = lambda: attention_cuda(inp["packed"], inp["idx"], inp["shifts"],  # noqa: E731
                                        inp["n_branches"], inp["c"])
        elif name == "windowed_attention_fwd_kernel":
            fn = lambda: windowed_attention_cuda(  # noqa: E731
                inp["packed"], inp["idx"], inp["shifts"], inp["n_branches"], inp["c"], inp["spec"])
        elif name == "scatter_mean_kernel":
            fn = lambda: scatter_mean_cuda(inp["features"], inp["knn_idx"],  # noqa: E731
                                           inp["num_fine"])
        elif name == "windowed_scatter_mean_kernel":
            fn = lambda: windowed_scatter_mean_cuda(  # noqa: E731
                inp["features"], inp["knn_idx"], inp["num_fine"], inp["spec"])
        elif name == "scatter_add_rows_kernel":
            fn = lambda: scatter_add_cuda(inp["grads"], inp["idx"], inp["num_points"])  # noqa: E731
        elif name == "gather_rows_kernel":
            fn = lambda: gather_cuda(inp["points"], inp["idx"])  # noqa: E731
        elif name == "ball_query_kernel":
            fn = lambda: ball_query_cuda(inp["radius"], inp["nsample"], inp["xyz"],  # noqa: E731
                                         inp["new_xyz"])
        elif name == "windowed_attention_bwd_kernel":
            fn = lambda: windowed_attention_bwd_cuda(  # noqa: E731
                inp["packed"], inp["idx"], inp["shifts"], inp["gctx"], inp["n_branches"],
                inp["c"], inp["spec"])
        else:
            fn = lambda: attention_bwd_cuda(inp["packed"], inp["idx"], inp["shifts"],  # noqa: E731
                                            inp["gctx"], inp["n_branches"], inp["c"])
        times.append(chip_smoke.time_graph(fn))
    return times


def run_root(args: list, root: Path, timeout: int = 1200):
    """This script with ``args`` in a subprocess whose ``mpa_tpu_torch``
    comes from ``root``: its last line of output as JSON, or None (with its
    errors printed) if it failed."""
    proc = subprocess.run([sys.executable, str(REPO / "profile_port.py"), *args,
                           "--root", str(root)], capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        print(f"{root} failed:\n{proc.stderr[-3000:]}", flush=True)
        return None
    return json.loads(proc.stdout.strip().splitlines()[-1])


def kernels_main(args) -> int:
    """``--kernels``: record (or reuse a recording), then time each root in
    its own process."""
    import tempfile

    names = set(args.names.split(",")) if args.names else set(TIMED)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        saved = Path(args.inputs) if args.inputs else Path(tmp) / "inputs.pt"
        record = ["--record-saved", str(saved)] + (["--bf16"] if args.bf16 else [])
        if not saved.exists() and run_root(record, REPO) is None:
            return 1
        meta = [(p, n, {k: tuple(v.shape) for k, v in inp.items() if torch.is_tensor(v)})
                for p, n, inp in torch.load(saved, weights_only=False) if n in names]
        keep = [n in names for _, n, _ in torch.load(saved, weights_only=False)]
        others = [Path(d).resolve() for d in args.against or []]
        roots = ([(d.name, d) for d in others] + [("this", REPO), ("this", REPO)]
                 + [(d.name, d) for d in reversed(others)])
        results = []
        for label, root in roots:
            got = run_root(["--time-saved", str(saved), "--names", ",".join(sorted(names))], root)
            if got is not None:
                results.append((label, [t for t, k in zip(got, keep) if k]))
            print(f"timed {label} ({root}){'' if got is not None else ': failed'}", flush=True)
    print("per launch ms: " + " | ".join(label for label, _ in results))
    for i, (path, name, shapes) in enumerate(meta):
        cols = " ".join(f"{t[i]:.4f}" for _, t in results)
        print(f"  {path:14s} {name:32s} {cols}  {shapes}")
    sums = {}
    for i, (path, name, _) in enumerate(meta):
        for j, (label, t) in enumerate(results):
            key = f"{path} {name}"
            sums.setdefault(key, {}).setdefault(f"{j}:{label}", 0.0)
            sums[key][f"{j}:{label}"] += t[i]
    print("sums per path (ms):")
    for key, cols in sums.items():
        print(f"  {key:48s} " + " ".join(f"{c}={v:.4f}" for c, v in cols.items()))
    out = REPO / "chiprun_out" / (args.out or "kernel_times.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "roots": [label for label, _ in results],
                               "launches": [{"path": p, "name": n, "shapes": s,
                                             "ms": [t[i] for _, t in results]}
                                            for i, (p, n, s) in enumerate(meta)],
                               "sums": sums}, indent=1))
    print(json.dumps({"card": card, "sums": sums}))
    return 0


def load_cfg(model: str):
    from mpa_tpu_torch.configs import PRESETS as CONFIGS

    return CONFIGS[PRESETS[model]].with_overrides(**OVERRIDES.get(model, {}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="cls", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=None, help="default: the preset's")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--train", action="store_true", help="profile train steps, not requests")
    ap.add_argument("--bf16", action="store_true",
                    help="cls or partseg with compute_dtype=torch.bfloat16 (with --kernels: "
                         "their bf16 launches)")
    ap.add_argument("--neighbor_mode", default=None, choices=["exact", "window", "window_all"],
                    help="partseg: its neighbour mode (default: the preset's, exact)")
    ap.add_argument("--kernels", action="store_true",
                    help="time the kernels' launches of the main paths")
    ap.add_argument("--against", nargs="*", default=None,
                    help="with --kernels: other checkouts' roots")
    ap.add_argument("--names", default=None, help="with --kernels: only these kernels (a,b)")
    ap.add_argument("--inputs", default=None,
                    help="with --kernels: keep the recording here, or reuse it")
    ap.add_argument("--out", default=None,
                    help="with --kernels: the file under chiprun_out/ (default "
                         "kernel_times.json)")
    ap.add_argument("--exported", action="store_true",
                    help="requests through the model's exported program (serve.export_inference, "
                         "then load_inference), not the eager loader")
    ap.add_argument("--time-saved", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--record-saved", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA card", file=sys.stderr)
        return 2
    if args.time_saved or args.record_saved:
        sys.path[:0] = [args.root, str(REPO)]
        if args.record_saved:
            record_kernel_inputs(Path(args.record_saved), args.bf16)
            print(json.dumps("recorded"))
        else:
            print(json.dumps(time_saved(Path(args.time_saved), set(args.names.split(",")))))
        return 0
    sys.path.insert(0, str(REPO))
    from mpa_tpu_torch.utils import profiling
    from mpa_tpu_torch.utils.profiling import category_breakdown, device_events, op_breakdown

    if args.kernels:
        return kernels_main(args)
    cfg = load_cfg(args.model)
    batch, points = args.batch or cfg.batch_size, cfg.num_points
    if args.model == "completion":
        points //= 2  # the partial clouds: the half of each with the lowest x
    if args.bf16 and args.model not in ("cls", "partseg"):
        ap.error("--bf16 takes --model cls or partseg")
    if args.neighbor_mode:
        if args.model != "partseg":
            ap.error("--neighbor_mode takes --model partseg")
        OVERRIDES["partseg"] = dict(neighbor_mode=args.neighbor_mode)
    dtype_kw = {"compute_dtype": torch.bfloat16} if args.bf16 else {}
    if args.exported and args.train:
        ap.error("--exported profiles requests, not train steps")
    run = (make_train_steps(args.model, batch, dtype_kw) if args.train
           else make_requests(args.model, batch, points, dtype_kw, args.exported))
    # Warm-ups; a request's clouds are made at its first call, so every traced
    # request is answered once before the trace, and the trace holds no data
    # generation.
    for i in range(2 if args.train else 2 + args.requests):
        run(i)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.spans = []  # the program's spans, so that the trace names its layers
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(args.requests):
                run(2 + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        profiling.spans = None
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = device_events(prof)
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
    by_kind = {r["category"]: r["ms"] / n for r in category_breakdown(prof)[1]}
    by_name = op_breakdown(prof)[1]
    wall_ms = wall * 1e3 / n
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    unit = "train step" if args.train else "request"
    mode = f" {args.neighbor_mode}" if args.neighbor_mode else ""
    print(f"{cfg.model}{mode}{' (bf16)' if args.bf16 else ''}"
          f"{' exported' if args.exported else ''}: batch {batch} x {points} points, "
          f"{n} traced {unit}s")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"wall per {unit} (profiler on): {wall_ms:.3f} ms; peak allocated {peak_gb:.2f} GB")
    print(f"device busy per {unit}: {busy / 1e3 / n:.3f} ms "
          f"({100 * busy / 1e3 / n / wall_ms:.1f}% of wall); "
          f"kernels per {unit}: {len(kernels) / n:.1f}")
    for k, v in by_kind.items():
        print(f"  {k:36s} {v:8.3f} ms")
    print(f"top kernels by device time per {unit}:")
    for r in by_name[:15]:
        print(f"  {r['ms'] / n:8.3f} ms  x{r['count'] / n:5.1f}  {r['name'][:110]}")
    print(json.dumps({"model": cfg.model, "neighbor_mode": args.neighbor_mode, "bf16": args.bf16,
                      "exported": args.exported,
                      "unit": unit, "wall_ms": wall_ms, "busy_ms": busy / 1e3 / n,
                      "by_kind_ms": dict(by_kind), "kernels_per_unit": len(kernels) / n,
                      "peak_allocated_gb": peak_gb}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
