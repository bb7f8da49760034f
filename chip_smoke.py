#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, markov_cls inference at the published
``scanobjectnn_cls`` width (1024 points, 15 classes, full ladder) with
random weights from a seed, and shows that it runs through the port's four
hand-written kernels:

1. the card (``nvidia-smi`` name and power limit), then the kernel build
   from ``mpa_tpu_torch/kernels/csrc`` and its seconds;
2. end to end: ``load_classifier`` on ``cuda`` answers two warm-up requests
   and then three requests of 64 clouds x 1024 points (made with numpy from a
   fixed seed), with every launch count set to 0 just before and read just
   after; the outputs must be finite log-probabilities and match the same
   weights run on the CPU (the plain ops) within 1e-3;
3. every kernel launch of one more request of the same shapes is replayed
   on its own inputs, kernel against its plain PyTorch version (FPS, gather
   and kNN indices exactly equal; attention and kNN distances within 1e-5
   relative), with the kernel's, the plain version's and, where one PyTorch
   call computes the same function, that call's time, beside the bound the
   card's memory rate and float32 rate put on the same work;
4. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; nothing falls back to
the CPU or to a plain version. Without a CUDA card, or away from the repo's
``mpa_tpu_torch`` package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
SOURCES = {
    "knn_kernel": ("mpa_tpu_torch/kernels/csrc/knn.cu", "mpa_tpu/ops/pallas/knn_pallas.py:102"),
    "fps_kernel": ("mpa_tpu_torch/kernels/csrc/fps.cu", "mpa_tpu/ops/pallas/fps_pallas.py:70"),
    "gather_rows_kernel": ("mpa_tpu_torch/kernels/csrc/gather.cu",
                           "mpa_tpu/ops/pallas/gather_pallas.py:97"),
    "transition_attention_fwd_kernel": ("mpa_tpu_torch/kernels/csrc/attention.cu",
                                        "mpa_tpu/ops/pallas/attention_pallas.py:452"),
}
ALSO_REPLACES = {"transition_attention_fwd_kernel": "mpa_tpu/ops/pallas/attention_pallas.py:347"}
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
    else:
        B, N, Win = inp["packed"].shape
        S, K = inp["idx"].shape[1:]
        Wo = inp["n_branches"] * inp["c"]
        has_shift = inp["shifts"] is not None
        nbytes = 4 * (B * N * Win + B * S * K + B * S * Wo * (2 if has_shift else 1))
        ops = B * S * Wo * K * (6 if has_shift else 5)
    return nbytes, ops


def check_call(name: str, inp: dict) -> dict:
    """Kernel against plain version on one recorded call, with its times."""
    from mpa_tpu_torch.ops.attention import attention_cuda, attention_plain
    from mpa_tpu_torch.ops.fps import fps_cuda, fps_plain
    from mpa_tpu_torch.ops.gather import gather_cuda, gather_plain
    from mpa_tpu_torch.ops.knn import knn_cuda, knn_plain

    library = None
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
        "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "ops_ms": ops / PEAK_F32_OPS_PER_S * 1e3,
    }
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    return row


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

    # -- 3. each kernel against its plain version, on the main path's inputs ----
    rows = []
    for name, inp in recorded:
        row = check_call(name, inp)
        rows.append(row)
        lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(f"[3 kernel] {name} {row['shape']}: max_abs_err {row['max_abs_err']:.3e}, "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {row['bound_ms']:.4f} ms")
    del recorded

    summary = []
    for name in kernels.KERNELS:
        mine = [r for r in rows if r["name"] == name]
        bytes_ms = sum(r["bytes_ms"] for r in mine)
        ops_ms = sum(r["ops_ms"] for r in mine)
        libs = [r["library_ms"] for r in mine]
        source, replaces = SOURCES[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "launches_per_request": len(mine),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if None in libs else sum(libs),
        }
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        summary.append(entry)
    log("[4 kernels] times are per request (B=64 x 1024 points): the sum over the "
        "request's launches of each")
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
