#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two main paths at the published ``scanobjectnn_cls``
width (1024 points, 15 classes, full ladder) with random weights from a
seed, markov_cls inference and markov_cls training, and shows that they run
through the port's six hand-written kernels (four forward, two backward):

1. the card (``nvidia-smi`` name and power limit), then the kernel build
   from ``mpa_tpu_torch/kernels/csrc`` and its seconds;
2. end to end: ``load_classifier`` on ``cuda`` answers two warm-up requests
   and then three requests of 64 clouds x 1024 points (made with numpy from a
   fixed seed), with every launch count set to 0 just before and read just
   after; the outputs must be finite log-probabilities and match the same
   weights run on the CPU (the plain ops) within 1e-3;
2b. training: the preset's train step (adam-l2, lr 1e-3, wd 1e-4, label
   smoothing 0.1, head dropout 0.5, train-mode BatchNorm) on ``cuda`` at
   B = 64 synthetic clouds: two warm-up steps, then five timed steps with
   every launch count set to 0 just before and read just after (the forward
   counts above plus 11 ``transition_attention_bwd_kernel`` and 5
   ``scatter_add_rows_kernel`` per step), finite losses; ten steps on one
   fixed batch must lower the loss; one step at B = 16 with dropout 0 on
   ``cuda`` and on the CPU (plain ops) from the same weights must agree in
   loss (1e-4), in every gradient (``grad_error_units`` at most
   ``GRAD_LIMIT``) and in the updated BatchNorm statistics (1e-4
   relative); and ``mpa_tpu_torch.cli.train`` runs three steps and its
   eval pass in-process;
3. every kernel launch of one more request of the same shapes, and every
   backward launch of one more train step, is replayed on its own inputs,
   kernel against its plain PyTorch version (FPS, gather and kNN indices
   exactly equal; attention and kNN distances within 1e-5 relative; the
   scatter-add within 1e-5 and the attention backward within 1e-4 relative,
   with an absolute floor at 1e-5 of the largest entry, for their atomic
   adds), with the kernel's, the plain version's and, where one PyTorch
   call computes the same function, that call's time, beside the bound the
   card's memory rate and float32 rate put on the same work; and the kNN
   distance gradient of one recorded feature-space kNN is held against
   torch autograd of the plain kNN;
4. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; nothing falls back to
the CPU or to a plain version. Without a CUDA card, or away from the repo's
``mpa_tpu_torch`` package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH, POINTS, REQUESTS, SEED = 64, 1024, 3, 0
PER_FORWARD = {
    "knn_kernel": 11,  # la0 self-kNN + spatial and feature kNN in la1..la5
    "fps_kernel": 5,  # one per ladder step
    "gather_rows_kernel": 10,  # new_xyz and center_feat in la1..la5
    "transition_attention_fwd_kernel": 11,  # la0 + two branches in la1..la5
}
PER_TRAIN_STEP = dict(
    PER_FORWARD,
    transition_attention_bwd_kernel=11,  # the backward of every attention call
    scatter_add_rows_kernel=5,  # the backward of center_feat's gather in la1..la5
)
BACKWARD = ("scatter_add_rows_kernel", "transition_attention_bwd_kernel")
TRAIN_WARMUP, TRAIN_STEPS, FIXED_STEPS, PARITY_BATCH, TRAIN_CLOUDS = 2, 5, 10, 16, 512
# The card's step against the CPU's: loss and BatchNorm statistics (relative)
# within 1e-4; every gradient within GRAD_LIMIT units of grad_error_units.
# cuBLAS and the CPU round float32 products differently and the atomic adds
# land in no fixed order; near-tie selections (feature kNN, max over K, max
# pool) amplify such last-bit differences in the gradients. On an H100 the
# correct step reads 4.0 units, and planted faults in the backward kernels
# read 182.7 (one edge of every scatter-add dropped) and 4194.5 (the
# attention's correction term dropped); PERF.md has the runs.
GRAD_LIMIT = 20
# Gradients that are zero up to rounding in this model: the k projections'
# biases (a shift of k cancels in the attention's normalisation), the q
# projections (no part in the output), and the biases of the Dense layers
# ahead of a train-mode BatchNorm. Only these get an absolute floor.
ROUNDING_ZERO = re.compile(
    r"(\.k\.bias|\.q\.(weight|bias)|\.linear\.bias|^fc[12]\.bias|\.final_class\.bias)$")
SOURCES = {
    "knn_kernel": ("mpa_tpu_torch/kernels/csrc/knn.cu", "mpa_tpu/ops/pallas/knn_pallas.py:102"),
    "fps_kernel": ("mpa_tpu_torch/kernels/csrc/fps.cu", "mpa_tpu/ops/pallas/fps_pallas.py:70"),
    "gather_rows_kernel": ("mpa_tpu_torch/kernels/csrc/gather.cu",
                           "mpa_tpu/ops/pallas/gather_pallas.py:97"),
    "transition_attention_fwd_kernel": ("mpa_tpu_torch/kernels/csrc/attention.cu",
                                        "mpa_tpu/ops/pallas/attention_pallas.py:452"),
    "scatter_add_rows_kernel": ("mpa_tpu_torch/kernels/csrc/scatter_add.cu",
                                "mpa_tpu/ops/pallas/gather_pallas.py:267"),
    "transition_attention_bwd_kernel": ("mpa_tpu_torch/kernels/csrc/attention_bwd.cu",
                                        "mpa_tpu/ops/pallas/attention_pallas.py:388"),
}
ALSO_REPLACES = {
    "transition_attention_fwd_kernel": "mpa_tpu/ops/pallas/attention_pallas.py:347",
    "scatter_add_rows_kernel": "mpa_tpu/ops/pallas/gather_pallas.py:190",
    "transition_attention_bwd_kernel": "mpa_tpu/ops/pallas/attention_pallas.py:483",
}
# H100 SXM data-sheet peaks: HBM3 rate, and float32 on the CUDA cores (the
# kernels' arithmetic; an FMA counts as two operations).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def time_graph(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median device milliseconds of one ``fn()`` call, from CUDA events
    around the replay of a CUDA graph of ``reps`` back-to-back calls (so host
    launch overhead is not counted). Inputs stay in L2 between calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def time_events(fn, reps: int = 3) -> float:
    """Median milliseconds of ``fn()`` between CUDA events, one call each
    (for the plain versions, whose host loops a graph would hide)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(name: str, inp: dict):
    """(bytes, operations) the call's work needs at least: each input read
    once and each output written once; operations counted from the shapes."""
    if name == "knn_kernel":
        B, N, C = inp["base"].shape
        S, k = inp["query"].shape[1], inp["k"]
        nbytes = 4 * (B * N * C + B * S * C) + 8 * B * S * k
        ops = B * S * N * (2 * C + 3) + 2 * B * (S + N) * C
    elif name == "fps_kernel":
        B, N, C = inp["points"].shape
        npoint = inp["npoint"]
        nbytes = 4 * B * N * C + 4 * B * npoint
        ops = B * npoint * N * 3 * C
    elif name == "gather_rows_kernel":
        B, _, W = inp["points"].shape
        E = inp["idx"].shape[1]
        nbytes = 2 * 4 * B * E * W + 4 * B * E
        ops = 0
    elif name == "scatter_add_rows_kernel":
        B, E, W = inp["grads"].shape
        nbytes = 4 * (B * E * W + B * E + B * inp["num_points"] * W)
        ops = B * E * W  # one add per gradient float
    elif name == "transition_attention_bwd_kernel":
        B, N, Win = inp["packed"].shape
        S, K = inp["idx"].shape[1:]
        Wo = inp["n_branches"] * inp["c"]
        sh = int(inp["shifts"] is not None)
        # packed, idx, gctx (and shifts) read once; dpacked (and dshift)
        # written once.
        nbytes = 4 * (2 * B * N * Win + B * S * K + B * S * Wo * (1 + 2 * sh))
        # Per (query, channel), from attention_bwd.cu with one neighbour at the
        # maximum (there is at least one): the denominator's K - 1 adds; per
        # neighbour a divide, subtract, multiply, compare (and the shift's
        # add); the tie's t and dshift terms, 7 (+1); the split and the
        # correction, 4; per neighbour one atomic add, and the tie's dE / dV
        # arithmetic, 7 (+1).
        ops = B * S * Wo * (K * (6 + sh) + 17 + 2 * sh)
    else:
        B, N, Win = inp["packed"].shape
        S, K = inp["idx"].shape[1:]
        Wo = inp["n_branches"] * inp["c"]
        has_shift = inp["shifts"] is not None
        nbytes = 4 * (B * N * Win + B * S * K + B * S * Wo * (2 if has_shift else 1))
        ops = B * S * Wo * K * (6 if has_shift else 5)
    return nbytes, ops


def assert_close_scaled(got, want, rtol: float, what: str) -> float:
    """|got - want| <= rtol * |want| + 1e-5 * max|want|: atomic adds land in
    no fixed order, and gradients come at any scale. Returns max |got - want|."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5 * scale + 1e-30,
                               msg=lambda m: f"{what}: {m}")
    return (got - want).abs().max().item()


def check_knn_grad(inp: dict) -> float:
    """The kNN distance gradient on CUDA (kernel values, gather and
    scatter-add kernels backward) against torch autograd of the plain kNN on
    the same inputs. The plain gradient comes from the expanded form
    |q|^2 + |b|^2 - 2 q.b, whose terms are of size |q| |g| and cancel, so the
    absolute floor scales with them."""
    from mpa_tpu_torch.ops.knn import knn, knn_plain

    k, base, query = inp["k"], inp["base"], inp["query"]
    weights = torch.linspace(0.5, 1.5, k, device=base.device)
    grads = []
    for fn in (knn, knn_plain):
        b, q = base.detach().clone().requires_grad_(True), query.detach().clone().requires_grad_(True)
        dist, _ = fn(k, b, q)
        grads.append(torch.autograd.grad((dist * weights).sum(), (b, q)))
    torch.cuda.synchronize()
    scale = 2 * k * 1.5 * max(float(base.abs().max()), float(query.abs().max()))
    err = 0.0
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)
        err = max(err, (got - want).abs().max().item())
    return err


def check_call(name: str, inp: dict) -> dict:
    """Kernel against plain version on one recorded call, with its times."""
    # A backward launch records tensors that autograd saved; replay them
    # detached, so that the plain version builds no graph.
    inp = {k: v.detach() if torch.is_tensor(v) else v for k, v in inp.items()}
    from mpa_tpu_torch.ops.attention import (
        attention_bwd_cuda, attention_bwd_plain, attention_cuda, attention_plain,
    )
    from mpa_tpu_torch.ops.fps import fps_cuda, fps_plain
    from mpa_tpu_torch.ops.gather import (
        gather_cuda, gather_plain, scatter_add_cuda, scatter_add_plain,
    )
    from mpa_tpu_torch.ops.knn import knn_cuda, knn_plain

    library, ref = None, None
    if name == "knn_kernel":
        k, base, query = inp["k"], inp["base"], inp["query"]
        kern, plain = (lambda: knn_cuda(k, base, query)), (lambda: knn_plain(k, base, query))
        library = lambda: torch.topk(torch.cdist(query, base), k, dim=-1, largest=False)  # noqa: E731
        (gd, gi), (wd, wi) = kern(), plain()
        if not torch.equal(gi, wi):
            raise AssertionError(f"knn_kernel indices differ from the plain version "
                                 f"at {int((gi != wi).sum())} places")
        torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-6)
        err = (gd - wd).abs().max().item()
        shape = f"base {tuple(base.shape)} query {tuple(query.shape)} k={k}"
    elif name == "fps_kernel":
        pts, npoint, start = inp["points"], inp["npoint"], inp["start_idx"]
        kern, plain = (lambda: fps_cuda(pts, npoint, start)), (lambda: fps_plain(pts, npoint, start))
        got, want = kern(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"fps_kernel differs from the plain version at "
                                 f"{int((got != want).sum())} places")
        err = 0.0
        shape = f"points {tuple(pts.shape)} npoint={npoint}"
    elif name == "gather_rows_kernel":
        pts, idx = inp["points"], inp["idx"]
        idx64 = idx.long()[..., None].expand(-1, -1, pts.shape[-1])
        kern, plain = (lambda: gather_cuda(pts, idx)), (lambda: gather_plain(pts, idx))
        library = lambda: torch.gather(pts, 1, idx64)  # noqa: E731
        got, want = kern(), plain()
        if not torch.equal(got, want):
            raise AssertionError("gather_rows_kernel differs from the plain version")
        err = 0.0
        shape = f"points {tuple(pts.shape)} idx {tuple(idx.shape)}"
    elif name == "scatter_add_rows_kernel":
        grads, idx, n = inp["grads"], inp["idx"], inp["num_points"]
        B, _, W = grads.shape
        kern, plain = (lambda: scatter_add_cuda(grads, idx, n)), (lambda: scatter_add_plain(grads, idx, n))
        rows = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n).reshape(-1)
        flat_grads = grads.reshape(-1, W)
        library = lambda: torch.zeros((B * n, W), device=grads.device).index_add_(  # noqa: E731
            0, rows, flat_grads)
        got, want = kern(), plain()
        err = assert_close_scaled(got, want, rtol=1e-5, what=name)
        ref = want.abs().max().item()
        shape = f"grads {tuple(grads.shape)} into N={n}"
    elif name == "transition_attention_bwd_kernel":
        args = (inp["packed"], inp["idx"], inp["shifts"], inp["gctx"], inp["n_branches"], inp["c"])
        kern, plain = (lambda: attention_bwd_cuda(*args)), (lambda: attention_bwd_plain(*args))
        (gp, gs), (wp, ws) = kern(), plain()
        err = assert_close_scaled(gp, wp, rtol=1e-4, what=f"{name} dpacked")
        if args[2] is not None:
            err = max(err, assert_close_scaled(gs, ws, rtol=1e-5, what=f"{name} dshift"))
        ref = wp.abs().max().item()
        shape = (f"packed {tuple(args[0].shape)} idx {tuple(args[1].shape)} "
                 f"shift={args[2] is not None} n_branches={args[4]}")
    else:
        args = (inp["packed"], inp["idx"], inp["shifts"], inp["n_branches"], inp["c"])
        kern, plain = (lambda: attention_cuda(*args)), (lambda: attention_plain(*args))
        got, want = kern(), plain()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        err = (got - want).abs().max().item()
        shape = (f"packed {tuple(args[0].shape)} idx {tuple(args[1].shape)} "
                 f"shift={args[2] is not None} n_branches={args[3]}")
    torch.cuda.synchronize()
    nbytes, ops = bound(name, inp)
    row = {
        "name": name,
        "shape": shape,
        "max_abs_err": err,
        "ms": time_graph(kern),
        "plain_ms": time_events(plain),
        "library_ms": None if library is None else time_graph(library),
        "max_abs_ref": ref,  # the gradients' scale, beside max_abs_err
        "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "ops_ms": ops / PEAK_F32_OPS_PER_S * 1e3,
    }
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    return row


def training_data():
    """The training CLI's synthetic clouds: ``TRAIN_CLOUDS`` of ``POINTS``."""
    from mpa_tpu_torch.data.synthetic import synthetic_clouds

    return synthetic_clouds(TRAIN_CLOUDS, POINTS, 15, seed=SEED)


def fresh_model(**kw):
    """The preset's classifier with weights drawn from ``SEED``."""
    from mpa_tpu_torch.models import get_model
    from mpa_tpu_torch.utils.init import init_like_flax

    model = get_model("markov_cls", num_classes=15, **kw)
    return init_like_flax(model, torch.Generator().manual_seed(SEED))


def grad_error_units(got: dict, want: dict) -> list:
    """Per parameter, the L2 distance of ``got``'s gradient from ``want``'s in
    units of 1e-3 of ``want``'s norm; for the tensors ``ROUNDING_ZERO`` names
    the unit adds 1e-5 of the whole gradient's norm. Largest first, as
    ``(name, units)``."""
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want.values())))
    units = {}
    for name, w in want.items():
        unit = 1e-3 * float(w.norm()) + (1e-5 * total if ROUNDING_ZERO.search(name) else 0.0)
        units[name] = float((got[name] - w).norm()) / max(unit, 1e-30)
    return sorted(units.items(), key=lambda kv: -kv[1])


def train_parity() -> dict:
    """One adam-l2 step with dropout 0 on the card and on the CPU (plain ops),
    from the same weights and the first ``PARITY_BATCH`` training clouds.
    Returns the loss difference, ``grad_error_units`` of the gradients, the
    worst relative error of a BatchNorm running statistic as ``(name,
    value)``, the card step's launch counts and both steps' wall seconds."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.configs import PRESETS
    from mpa_tpu_torch.train import create_train_state, make_cls_train_step

    cfg = PRESETS["scanobjectnn_cls"].with_overrides(seed=SEED)
    pts, labels = training_data()
    model = fresh_model(dropout=0.0)
    results = {}
    for device in (torch.device("cuda"), torch.device("cpu")):
        state = create_train_state(copy.deepcopy(model), cfg, device)
        x = torch.from_numpy(pts[:PARITY_BATCH]).to(device)
        y = torch.from_numpy(labels[:PARITY_BATCH]).to(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(make_cls_train_step(cfg, TRAIN_CLOUDS // BATCH)(state, x, y))
        wall = time.perf_counter() - t0
        grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in state.model.named_buffers() if "running" in n}
        results[device.type] = (loss, grads, stats, wall, dict(kernels.LAUNCHES))
    (lg, gg, sg, wg, launches), (lc, gc, sc, wc, _) = results["cuda"], results["cpu"]
    stat_err = {n: float((sg[n] - sc[n]).norm() / sc[n].norm().clamp_min(1e-30)) for n in sc}
    return {
        "loss_diff": abs(lg - lc),
        "grad_units": grad_error_units(gg, gc),
        "stat": max(stat_err.items(), key=lambda kv: kv[1]),
        "launches": launches,
        "cuda_s": wg,
        "cpu_s": wc,
    }


def train_phase() -> dict:
    """Phase 2b: the train step on the card, its launch counts, the loss on a
    fixed batch, the CUDA step against the CPU step, and the training CLI."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.configs import PRESETS
    from mpa_tpu_torch.train import create_train_state, make_cls_train_step

    cfg = PRESETS["scanobjectnn_cls"].with_overrides(seed=SEED)
    pts, labels = training_data()
    steps_per_epoch = TRAIN_CLOUDS // BATCH
    cuda = torch.device("cuda")

    def batch(i):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        return torch.from_numpy(pts[sl]).to(cuda), torch.from_numpy(labels[sl]).to(cuda)

    # Timed steps, with the launch counts of exactly those steps.
    state = create_train_state(fresh_model(), cfg, cuda)
    step = make_cls_train_step(cfg, steps_per_epoch)
    for i in range(TRAIN_WARMUP):
        step(state, *batch(i))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        x, y = batch(TRAIN_WARMUP + i)
        t0 = time.perf_counter()
        losses.append(float(step(state, x, y)))  # float() waits for the step
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"[2b train] step {i}: B={BATCH} x {POINTS} pts, loss {loss:.4f}, "
            f"{dt * 1e3:.3f} ms, {BATCH / dt:.1f} clouds/s")
    log(f"[2b train] launches over {TRAIN_STEPS} steps: {launches}")
    for name, per in PER_TRAIN_STEP.items():
        if launches[name] != per * TRAIN_STEPS:
            raise AssertionError(f"{name}: {launches[name]} launches, want {per} per train step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train losses {losses}")

    # One more step records the backward launches' inputs for phase 3.
    kernels.recorded = []
    step(state, *batch(TRAIN_WARMUP + TRAIN_STEPS))
    torch.cuda.synchronize()
    recorded = [(n, inp) for n, inp in kernels.recorded if n in BACKWARD]
    kernels.recorded = None
    del state

    # Ten steps on one fixed batch must lower the loss.
    state = create_train_state(fresh_model(), cfg, cuda)
    step = make_cls_train_step(cfg, steps_per_epoch)
    x, y = batch(0)
    fixed = [float(step(state, x, y)) for _ in range(FIXED_STEPS)]
    log(f"[2b train] {FIXED_STEPS} steps on one batch: loss {fixed[0]:.4f} -> {fixed[-1]:.4f}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {fixed}")
    del state

    parity = train_parity()
    log(f"[2b train] cuda vs cpu, one step at B={PARITY_BATCH} "
        f"({parity['cuda_s'] * 1e3:.1f} ms on the card, {parity['cpu_s']:.1f} s on the host): "
        f"loss |d| {parity['loss_diff']:.3e} (limit 1e-4); gradient error in units of "
        f"grad_error_units (limit {GRAD_LIMIT}), largest: "
        + ", ".join(f"{n} {u:.3f}" for n, u in parity["grad_units"][:3])
        + f"; worst statistic {parity['stat'][0]} rel {parity['stat'][1]:.3e} (limit 1e-4)")
    if (not parity["loss_diff"] <= 1e-4 or parity["grad_units"][0][1] > GRAD_LIMIT
            or parity["stat"][1] > 1e-4):
        raise AssertionError("the CUDA train step differs from the CPU step")

    # The training CLI, in-process.
    out = cli_train.main(["--device", "cuda", "--max_steps", "3", "--seed", str(SEED)])
    if out["steps"] != 3 or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"cli.train: {out}")
    log(f"[2b train] cli.train: 3 steps, losses {out['losses']}, eval instance acc "
        f"{out['instance_acc']:.4f}")
    return {"launches": launches, "recorded": recorded,
            "step_ms": [t * 1e3 for t in times]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (REPO / "mpa_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no mpa_tpu_torch package beside {__file__}; run it from the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.kernels import build
    from mpa_tpu_torch.serve import load_classifier

    t_all = time.perf_counter()
    card = card_line()
    log(f"[1 card] {card}")
    log(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    build.build(force=True)
    build.load()
    log(f"[1 build] {len(list(build.CSRC.glob('*.cu')))} sources -> {build.BUILD_DIR / build.LIB_NAME} "
        f"in {build.build_seconds:.2f} s")
    for line in build.ptxas_log.splitlines():
        if "Used" in line or "spill" in line or line.startswith("=="):
            log(f"[1 build] {line.strip()}")

    # -- 2. end to end ---------------------------------------------------------
    clf = load_classifier("scanobjectnn_cls", seed=SEED)
    rng = np.random.default_rng(SEED)
    requests = [rng.standard_normal((BATCH, POINTS, 3)).astype(np.float32)
                for _ in range(REQUESTS + 1)]
    for _ in range(2):  # warm-up: kernel loading, allocator growth
        clf(requests[0])
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    outputs, latencies = [], []
    for req in requests[1:]:
        t0 = time.perf_counter()
        out = clf(req)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        outputs.append(out)
    launches = dict(kernels.LAUNCHES)

    # One more request of the same shapes records every kernel's inputs for
    # phase 3 (recording keeps them alive, so it stays out of the timed ones).
    kernels.recorded = []
    clf(requests[1])
    recorded, kernels.recorded = kernels.recorded, None

    for i, lat in enumerate(latencies):
        log(f"[2 e2e] request {i}: B={BATCH} x {POINTS} pts, {lat * 1e3:.3f} ms, "
            f"{BATCH / lat:.1f} clouds/s")
    log(f"[2 e2e] launches over {REQUESTS} requests: {launches}")
    for name, per in PER_FORWARD.items():
        if launches[name] != per * REQUESTS:
            raise AssertionError(f"{name}: {launches[name]} launches, want {per} per forward")
    for out in outputs:
        if tuple(out.shape) != (BATCH, 15) or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)}")
        torch.testing.assert_close(out.exp().sum(-1), torch.ones(BATCH, device=out.device),
                                   rtol=0, atol=1e-4)
    cpu = load_classifier("scanobjectnn_cls", seed=SEED, device="cpu")
    t0 = time.perf_counter()
    want = cpu(requests[1])
    t_cpu = time.perf_counter() - t0
    got = outputs[0].cpu()
    diff = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[2 e2e] cuda vs cpu (plain ops, {t_cpu:.1f} s on the host): max |dlogp| = {diff:.3e} "
        f"(limit 1e-3), argmax agreement {agree:.4f}")
    if not diff <= 1e-3:
        raise AssertionError(f"cuda and cpu log-probs differ by {diff}")

    # -- 2b. training ------------------------------------------------------------
    train = train_phase()

    # -- 3. each kernel against its plain version, on the main paths' inputs ---
    knn_feature = next(inp for name, inp in recorded
                       if name == "knn_kernel" and inp["base"].shape[-1] > 3)
    rows = []
    for name, inp in recorded + train["recorded"]:
        row = check_call(name, inp)
        rows.append(row)
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        ref = "" if row["max_abs_ref"] is None else f" (of max |ref| {row['max_abs_ref']:.3e})"
        log(f"[3 kernel] {name} {row['shape']}: max_abs_err {row['max_abs_err']:.3e}{ref}, "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {row['bound_ms']:.4f} ms")
    err = check_knn_grad(knn_feature)
    log(f"[3 kernel] knn distance gradient (gather_rows_kernel + scatter_add_rows_kernel) "
        f"base {tuple(knn_feature['base'].shape)} query {tuple(knn_feature['query'].shape)}: "
        f"max_abs_err {err:.3e} against autograd of the plain kNN")
    del recorded, train["recorded"], knn_feature

    summary = []
    for name in kernels.KERNELS:
        mine = [r for r in rows if r["name"] == name]
        bytes_ms = sum(r["bytes_ms"] for r in mine)
        ops_ms = sum(r["ops_ms"] for r in mine)
        libs = [r["library_ms"] for r in mine]
        source, replaces = SOURCES[name]
        backward = name in BACKWARD
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # the main path whose timed run the count is from: the served
            # requests for the forward kernels, the timed train steps for the
            # backward kernels
            "launches": train["launches"][name] if backward else launches[name],
            "train_launches": train["launches"][name],
            "per": "train step" if backward else "request",
            ("launches_per_step" if backward else "launches_per_request"): len(mine),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_abs_ref": max(r["max_abs_ref"] for r in mine) if backward else None,
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if None in libs else sum(libs),
        }
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        summary.append(entry)
    log("[4 kernels] times are per request for the forward kernels and per train step for "
        "the backward kernels (B=64 x 1024 points): the sum over its launches of each")
    log(f"[4 train] ms per step {train['step_ms']}, median "
        f"{statistics.median(train['step_ms']):.3f} ms, "
        f"{BATCH / statistics.median(train['step_ms']) * 1e3:.1f} clouds/s")
    print(card, flush=True)  # the card, exactly as nvidia-smi reports it
    log(f"[4 total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
