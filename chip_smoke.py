#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at their presets' published widths with
random weights from a seed: ``markov_cls`` (``scanobjectnn_cls``: 1024
points, 15 classes, full ladder) served and trained, ``markov_partseg``
(``shapenetpart``: 2048 points, ladder 1024/512/256/128, 16 categories, 50
parts) served and trained, ``markov_semseg`` in the Morton-window mode
``window_all`` at the large-scene shape (``s3dis_semseg`` at 16384 points,
B = 2, ladder 8192/4096/2048/1024, 13 classes) served and trained,
``repsurf_ssg_2x`` (``scanobjectnn_2x``: 1024 points, 15 classes, SA ladder
512/128/32, widths up to 2048) served and trained, ``markov_partseg_fp``
(``shapenetpart_fp``, B = 32 x 2048), ``markov_pose`` (``pose_modelnet40``,
B = 64 x 1024) and ``markov_completion`` (``completion``, B = 64 x 512
partial points against 1024) served and trained, ``markov_partseg`` served
in the ``window`` and ``window_all`` modes, the published recipe of cls
and part-seg through ``cli.train`` and ``cli.eval`` (phase 5) and the
S3DIS rooms through ``cli.train`` and the sliding scene inference (phase
6). It shows that they run through the port's twelve hand-written kernels
(nine forward, three backward):

1. the card (``nvidia-smi`` name and power limit), then the kernel build
   from ``mpa_tpu_torch/kernels/csrc`` and its seconds;
2. cls served: ``load_classifier`` on ``cuda`` answers two warm-up requests
   and then three requests of 64 clouds x 1024 points (made with numpy from a
   fixed seed), with every launch count set to 0 just before and read just
   after; the outputs must be finite log-probabilities and match the same
   weights run on the CPU (the plain ops) within 1e-3;
2b. cls trained: the preset's train step (adam-l2, lr 1e-3, wd 1e-4, label
   smoothing 0.1, head dropout 0.5, train-mode BatchNorm) on ``cuda`` at
   B = 64 synthetic clouds: two warm-up steps, then five timed steps with
   every launch count set to 0 just before and read just after, finite
   losses; ten steps on one fixed batch must lower the loss; one step at
   B = 16 with dropout 0 on ``cuda`` and on the CPU (plain ops) from the same
   weights must agree in loss (1e-4), in every gradient
   (``grad_error_units`` at most the path's ``grad_limit``) and in the
   updated BatchNorm statistics (1e-4 relative); and
   ``mpa_tpu_torch.cli.train`` runs three steps and its eval pass in-process;
2c. part-seg served: ``load_segmenter`` on ``cuda``, two warm-up and three
   timed requests of 32 clouds x 2048 points with their categories
   (``realistic_partseg``), launch counts read and asserted
   (``scatter_mean_kernel`` included), finite log-probs whose rows sum to 1;
   the first four clouds of a request on the card against the CPU plain ops
   from the same weights (``segmentation_agreement`` within ``SEG_LIMITS``);
2d. part-seg trained: the preset's step (SGD 0.1 / momentum 0.9 / wd 1e-4,
   cosine, smoothing 0.1, dropout 0.5) at B = 32, with the checks of 2b (the
   parity step at B = 4) and a three-step ``cli.train --preset
   shapenetpart``;
2e. semseg served: ``load_semantic_segmenter(num_points=16384,
   neighbor_mode="window_all")`` on ``cuda``, two warm-up and three timed
   requests of 2 blocks x 16384 points x 9 features (``synthetic_semseg``),
   launch counts read and asserted (the four windowed kernels; no exact kNN,
   attention or scatter-mean), finite log-probs whose rows sum to 1; the
   card against the CPU plain ops from the same weights at the preset's 4096
   points, B = 1, within ``SEMSEG_LIMITS``;
2f. semseg trained: the preset's step (as part-seg's) at B = 2 x 16384 in
   window_all, with the checks of 2b (the parity step at B = 1 x 4096) and a
   three-step ``cli.train --preset s3dis_semseg --num_points 16384
   --batch_size 2 --neighbor_mode window_all``;
2g. repsurf served: ``load_classifier("scanobjectnn_2x")`` on ``cuda``, two
   warm-up and three timed requests of 64 ``surface_clouds`` x 1024
   points (surfaces normalised to the unit sphere, as ScanObjectNN's
   objects are, so that the balls hold neighbours), launch counts read and asserted (three ``ball_query_kernel``
   launches a request), finite log-probs, the card against the CPU plain ops
   from the same weights within 1e-3;
2h. repsurf trained: the preset's adam-l2 step (dropout 0.4, the umbrella's
   normal flips from the state's generator) at B = 64 ``surface_clouds``,
   with the checks of 2b
   (the parity step at B = 16 with the same flips on both sides) and a
   three-step ``cli.train --preset scanobjectnn_2x``; then one request of
   ``markov_semseg`` in the ``window`` mode at 16384 points (B = 2), whose
   exact FPS over 16384 points and exact feature kNNs are replayed in
   phase 3;
2i-2n. ``markov_partseg_fp``, ``markov_pose`` and ``markov_completion``,
   each served (``load_segmenter("shapenetpart_fp")``,
   ``load_pose_regressor``, ``load_completer``: two warm-up and three timed
   requests, launch counts exact, log-probs whose rows sum to 1,
   orthonormal rotations of determinant 1, finite clouds of the right
   sizes; the card against the CPU plain ops on ``parity_batch`` clouds
   within ``SEG_LIMITS`` or ``CLOUD_LIMITS``) and trained as 2b (with the
   steps' peak memory), and replayed in phase 3;
2o. ``markov_partseg`` served by ``load_segmenter(neighbor_mode=MODE)`` in
   ``window`` and ``window_all`` at B = 32 x 2048: three timed requests,
   launch counts exactly ``PARTSEG_WINDOW_FORWARD``'s, the card against the
   CPU at B = 4 within ``SEG_LIMITS``, every launch of one more request
   replayed (``partseg_MODE`` in phase 3);
3. every kernel launch of one more request of each model, and every
   backward launch and gather of one more train step of each, is replayed
   on its own inputs, kernel against its plain PyTorch version (FPS,
   gather, and kNN indices and distances exactly equal; the attention
   forward bit-equal;
   the scatter-add within 1e-5 and the attention backward within 1e-4
   relative, with an absolute floor at 1e-5 of the largest entry, for their
   atomic adds; the scatter-mean's count exactly equal, its mean bit-equal
   to the plain version run on the CPU, unchanged by a second launch, and
   within 1e-5 of the plain version on the card, whose ``index_add_`` is
   atomic; the windowed kNN's indices and distances and the windowed
   attention forward bit-equal, every windowed index inside its window; the
   windowed attention backward as the exact one, the windowed scatter-mean as
   the exact one; the ball query's sentinel stage bit-equal), with the
   kernel's, the plain version's and, where one PyTorch
   call computes the same function, that call's time (for the scatter-means
   ``scatter_reduce_(reduce="mean", include_self=False)``, and beside it
   ``index_add_`` twice and a divide), beside the bound the
   card's memory rate and float32 rate put on the same work, and for FPS the
   chain floor (the same launch with its distance work cut: the time of
   its npoint dependent rounds of reduction and barrier); the kNN
   distance gradient of one recorded feature-space kNN (windowed for semseg)
   is held against torch autograd of the plain kNN (its gathers replayed
   too), and the scatter-means' backward at every recorded launch against
   autograd of the plain version; and an empty kernel is timed the way the
   kernels are, the floor of a launch;
5. the published recipe (run after phase 3, before the lines of 4):
   ``markov_cls`` (``modelnet40_cls``, 40 classes, B = 64 x 1024) and
   ``markov_partseg`` (``shapenetpart``, B = 32 x 2048) through the entry
   points a user calls, on a ModelNet40 and a ShapeNetPart tree written in
   their own text formats (``synthetic_clouds`` and ``realistic_partseg``;
   192 train and 64 test clouds, 96 and 32): ``cli.train`` takes three
   steps, one epoch (part-seg with its scale and shift augmentation, whose
   mean change is logged), ends it with its eval (three votes for cls) and
   keeps a checkpoint, its launches exactly three train steps' and the
   eval's forwards; the checkpoint, restored weights only into a fresh
   model on the card, gives bit for bit the trained model's log-probs;
   ``cli.eval --checkpoint --num_votes 3 --num_repeat 2`` gives metrics in
   [0, 1] with launches of votes x batches x the path's forward; the vote
   pool of the first ``parity_batch`` test clouds on the card agrees with
   the CPU's (plain ops, the same weights and vote scales) within cls's
   served limit (max 1e-3) or ``SEG_LIMITS``; the eval's clouds/s (votes x
   clouds over the median pass) and the train steps' ms are logged;
6. the S3DIS scene path (run after phase 5): three rooms written as
   ``Area_*.npy`` files (``S3DIS_ROOMS``), ``cli.train --preset
   s3dis_semseg --dataset s3dis`` three steps at B = 16 x 4096 (exact
   mode) and its eval, launches exactly the steps' and the eval's forwards;
   ``scene_inference`` of the Area 5 room through
   ``load_semantic_segmenter`` on the card (4096-point blocks, batches of
   8, launches exactly its batches' forwards, its seconds, and the seconds
   of the same scene with a forward that returns zeros); the scene of a
   small room on the card and on the CPU, their per-point labels agreeing
   on at least ``SEMSEG_LIMITS``' argmax share; the exact model's
   log-probs on one 4096-point block within ``SEMSEG_LIMITS`` and its train
   step at B = 1 x 4096 within ``S3DIS_PATH``'s ``grad_limit``, card
   against CPU; and every launch of ``cli.train``'s first step and of the
   scene's first batch replayed as in phase 3 (tagged ``s3dis``);
4. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero; nothing falls back to
the CPU or to a plain version. Without a CUDA card, or away from the repo's
``mpa_tpu_torch`` package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
REQUESTS, SEED = 3, 0
TRAIN_WARMUP, TRAIN_STEPS, FIXED_STEPS = 2, 5, 10
BACKWARD = ("scatter_add_rows_kernel", "transition_attention_bwd_kernel",
            "windowed_attention_bwd_kernel")
# repsurf_ssg_2x: the umbrella's self-kNN and its one gather, and per ball
# stage FPS, the ball query and the gathers of the new centres and normals
# and of the grouped normals and centres (and features, from sa2 on).
REPSURF_FORWARD = {
    "knn_kernel": 1,
    "fps_kernel": 3,
    "ball_query_kernel": 3,
    "gather_rows_kernel": 15,  # 1 + 4 + 5 + 5
}
CLS_FORWARD = {
    "knn_kernel": 11,  # la0 self-kNN + spatial and feature kNN in la1..la5
    "fps_kernel": 5,  # one per ladder step
    "gather_rows_kernel": 10,  # new_xyz and center_feat in la1..la5
    "transition_attention_fwd_kernel": 11,  # la0 + two branches in la1..la5
}
PARTSEG_FORWARD = {
    # la0's self-kNN, spatial + feature in la1..la4 and in the four decoder
    # states (scale 0 reuses la0's), six fresh ones for Fuse's non-adjacent pairs
    "knn_kernel": 22,
    "fps_kernel": 4,
    "gather_rows_kernel": 18,  # new_xyz and center_feat in la1..la4, ten finer sources in Fuse
    # la0, then per state one two-branch call (xyz + spatial) and one feature call
    "transition_attention_fwd_kernel": 17,
    "scatter_mean_kernel": 14,  # four decoder upsamples, ten coarser sources in Fuse
}
# markov_partseg_fp at 2048 points (shapenetpart_fp's 4-level ladder): la0's
# self-kNN and attention; per level FPS on the feature cloud, the gathers of
# new_xyz and center_feat, the spatial kNN and one attention; per decoder
# step a self-kNN and an attention (upla), and the 3-NN search and the row
# gather of the interpolation.
PARTSEG_FP_FORWARD = {
    "knn_kernel": 13,  # 1 + 4 + 4 + 4 (k = 3)
    "fps_kernel": 4,
    "gather_rows_kernel": 12,  # 4 + 4 + 4 (the interpolations' [B, 3N] rows)
    "transition_attention_fwd_kernel": 9,  # 1 + 4 + 4
}
# markov_partseg in the window modes at 2048 points: every scale pair of the
# ladder admits a window. ``window`` keeps the feature-space searches (la1..4
# and the four decoder states) and their attention exact; ``window_all``
# bands them too (its FPS bands fold into one launch a level).
PARTSEG_WINDOW_FORWARD = {
    "window": {"windowed_knn_kernel": 14, "knn_kernel": 8, "fps_kernel": 4,
               "gather_rows_kernel": 18, "windowed_attention_fwd_kernel": 9,
               "transition_attention_fwd_kernel": 8, "windowed_scatter_mean_kernel": 14},
    "window_all": {"windowed_knn_kernel": 22, "fps_kernel": 4, "gather_rows_kernel": 18,
                   "windowed_attention_fwd_kernel": 17, "windowed_scatter_mean_kernel": 14},
}
# markov_semseg in window_all at 16384 points: every scale pair admits a
# window, so every search, attention and upsample is windowed, FPS banded.
SEMSEG_FORWARD = {
    # la0's self search, spatial + feature in la1..la4, three spatial and four
    # feature ones in the decoder states (scale 0 reuses la0's), six fresh
    # ones for Fuse's non-adjacent pairs
    "windowed_knn_kernel": 22,
    "fps_kernel": 4,  # one launch per ladder step, its bands folded into the batch
    "gather_rows_kernel": 18,  # as part-seg
    "windowed_attention_fwd_kernel": 17,  # as part-seg
    "windowed_scatter_mean_kernel": 14,  # as part-seg
}
# The card's step against the CPU's: loss and BatchNorm statistics (relative)
# within 1e-4; every gradient within ``grad_limit`` units of grad_error_units.
# cuBLAS and the CPU round float32 products differently and the atomic adds
# land in no fixed order; near-tie selections (feature kNN, max over K, max
# pool) amplify such last-bit differences in the gradients. PERF.md has the
# readings of a correct step and of planted kernel faults that set each limit.
PATHS = {
    "cls": dict(
        preset="scanobjectnn_cls", batch=64, points=1024, parity_batch=16,
        per_forward=CLS_FORWARD,
        per_train_step=dict(
            CLS_FORWARD,
            transition_attention_bwd_kernel=11,  # the backward of every attention call
            scatter_add_rows_kernel=5,  # the backward of center_feat's gather in la1..la5
        ),
        grad_limit=20,
    ),
    "partseg": dict(
        preset="shapenetpart", batch=32, points=2048, parity_batch=4,
        per_forward=PARTSEG_FORWARD,
        per_train_step=dict(
            PARTSEG_FORWARD,
            gather_rows_kernel=18 + 14,  # the backward of every scatter-mean
            transition_attention_bwd_kernel=17,
            scatter_add_rows_kernel=14,  # center_feat's gathers and Fuse's ten
        ),
        grad_limit=20,
    ),
    "semseg": dict(
        # s3dis_semseg at the large-scene shape: B = 2 blocks of 16384 points,
        # ladder 8192/4096/2048/1024, window_all; the card-against-CPU checks
        # at the preset's own 4096 points, B = 1.
        preset="s3dis_semseg", batch=2, points=16384, parity_batch=1, parity_points=4096,
        overrides=dict(num_points=16384, batch_size=2, neighbor_mode="window_all"),
        cli=["--num_points", "16384", "--batch_size", "2", "--neighbor_mode", "window_all",
             "--eval_clouds", "4"],
        per_forward=SEMSEG_FORWARD,
        per_train_step=dict(
            SEMSEG_FORWARD,
            gather_rows_kernel=18 + 14,  # the backward of every scatter-mean
            windowed_attention_bwd_kernel=17,
            scatter_add_rows_kernel=14,  # center_feat's gathers and Fuse's ten
        ),
        grad_limit=20,
    ),
    "repsurf": dict(
        preset="scanobjectnn_2x", batch=64, points=1024, parity_batch=16,
        per_forward=REPSURF_FORWARD,
        per_train_step=dict(
            REPSURF_FORWARD,
            # the backward of each gather whose source carries a gradient: the
            # normals' (new and grouped, 3 + 3) and the features' (sa2, sa3)
            scatter_add_rows_kernel=8,
        ),
        grad_limit=20,
    ),
    "partseg_fp": dict(
        preset="shapenetpart_fp", batch=32, points=2048, parity_batch=4,
        per_forward=PARTSEG_FP_FORWARD,
        per_train_step=dict(
            PARTSEG_FP_FORWARD,
            transition_attention_bwd_kernel=9,
            # center_feat's gathers and the interpolations' (3 edges a row)
            scatter_add_rows_kernel=8,
        ),
        grad_limit=20,
    ),
    # markov_pose and markov_completion run the cls encoder: cls's launches.
    "pose": dict(
        preset="pose_modelnet40", batch=64, points=1024, parity_batch=16,
        per_forward=CLS_FORWARD,
        per_train_step=dict(CLS_FORWARD, transition_attention_bwd_kernel=11,
                            scatter_add_rows_kernel=5),
        grad_limit=20,
    ),
    # 512 partial points (the half of each 1024-point cloud with the lowest x)
    # against the 1024: its first FPS takes all 512.
    "completion": dict(
        preset="completion", batch=64, points=512, parity_batch=16,
        per_forward=CLS_FORWARD,
        per_train_step=dict(CLS_FORWARD, transition_attention_bwd_kernel=11,
                            scatter_add_rows_kernel=5),
        grad_limit=20,
    ),
}
# Phase 6's S3DIS path: exact markov_semseg at the preset's own shape, B = 16
# blocks of 4096 points, which launches what part-seg's does; its step
# against the CPU's at B = 1.
S3DIS_PATH = dict(preset="s3dis_semseg", batch=16, points=4096, parity_batch=1,
                  per_forward=PARTSEG_FORWARD, per_train_step=PATHS["partseg"]["per_train_step"],
                  grad_limit=20)


def path_spec(path: str) -> dict:
    """The entry of ``PATHS`` for ``path``, or ``S3DIS_PATH`` for ``"s3dis"``."""
    return S3DIS_PATH if path == "s3dis" else PATHS[path]


# The served part-seg log-probs on the card against the CPU's, per point the
# largest difference over the 50 parts: limits on its median over the points
# and on the share of points whose argmax agrees. A feature-space neighbour
# that flips on a last bit moves single points by far more, so the maximum is
# reported and not limited. PERF.md has the readings that set the limits.
SEG_LIMITS = {"median_abs": 1e-4, "argmax_agreement": 0.99}
# The same for markov_semseg window_all at 4096 points, B = 1 (13 classes).
SEMSEG_LIMITS = {"median_abs": 1e-4, "argmax_agreement": 0.99}
# The served repsurf log-probs against the CPU's: cls's limit on the largest
# difference (phase 2g holds it; ``--parity repsurf`` reads it).
REPSURF_LIMITS = {"max_abs": 1e-3}
# The served rotations and completed clouds against the CPU's: cls's limit on
# the largest difference of an entry.
CLOUD_LIMITS = {"max_abs": 1e-3}
# Gradients that are zero up to rounding in these models: the k projections'
# biases (a shift of k cancels in the attention's normalisation), the q
# projections (no part in the output), and the biases of the Dense layers
# ahead of a train-mode BatchNorm (in repsurf also the umbrella's last one,
# whose shift every consumer of the normals passes to a train-mode
# BatchNorm, and the last BatchNorm bias of the group-all stage: its max over
# 32 centres is positive in every cloud, so the shift passes through the max
# to the head's train-mode BatchNorm; in markov_partseg_fp likewise the
# BatchNorm bias of conv6, whose max over each cloud's points is broadcast
# to every point of head1's train-mode BatchNorm). Only these get an
# absolute floor.
ROUNDING_ZERO = re.compile(
    r"(\.k\.bias|\.q\.(weight|bias)|\.linear\.bias|^fc[12]\.bias|\.final_class\.bias"
    r"|\.mlp_[lf]0\.bias|\.conv\d+\.bias|surface_constructor\.mlp[12]\.bias"
    r"|^sa4\.mlps\.bn1\.bias|^conv6\.norm\.bias)$")
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
    "scatter_mean_kernel": ("mpa_tpu_torch/kernels/csrc/scatter_mean.cu",
                            "mpa_tpu/ops/pallas/scatter_pallas.py:70"),
    "windowed_knn_kernel": ("mpa_tpu_torch/kernels/csrc/window_knn.cu",
                            "mpa_tpu/ops/pallas/window_attention.py:153"),
    "windowed_attention_fwd_kernel": ("mpa_tpu_torch/kernels/csrc/window_attention.cu",
                                      "mpa_tpu/ops/pallas/window_attention.py:399"),
    "windowed_attention_bwd_kernel": ("mpa_tpu_torch/kernels/csrc/window_attention_bwd.cu",
                                      "mpa_tpu/ops/pallas/window_attention.py:431"),
    "windowed_scatter_mean_kernel": ("mpa_tpu_torch/kernels/csrc/window_scatter_mean.cu",
                                     "mpa_tpu/ops/pallas/window_attention.py:577"),
    "ball_query_kernel": ("mpa_tpu_torch/kernels/csrc/ball_query.cu",
                          "mpa_tpu/ops/pallas/ball_pallas.py:72"),
}
ALSO_REPLACES = {
    "gather_rows_kernel": "mpa_tpu/ops/pallas/gather_pallas.py:69",
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


def launch_floor() -> float:
    """``time_graph`` of an empty kernel: what one launch costs in the
    harness the kernels are timed with."""
    from mpa_tpu_torch.kernels import build

    lib = build.load()
    return time_graph(lambda: build.check(
        lib.mpa_empty(torch.cuda.current_stream().cuda_stream), "empty_kernel"))


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
    elif name == "windowed_knn_kernel":
        B, N, C = inp["base"].shape
        S, k = inp["query"].shape[1], inp["k"]
        nbytes = 4 * (B * N * C + B * S * C) + 8 * B * S * k
        # Each query's distances to its window's rows, the norms, and the
        # direct-form distances of the k it keeps.
        ops = B * S * inp["spec"].window * (2 * C + 3) + 2 * B * (S + N) * C + 3 * B * S * k * C
    elif name == "ball_query_kernel":
        B, N, C = inp["xyz"].shape
        S, ns = inp["new_xyz"].shape[1], inp["nsample"]
        nbytes = 4 * (B * N * C + B * S * C + B * S * ns)
        # Each centre's distance tests up to its nsample-th hit, or to every
        # point where it has fewer (this call's balls, not the most there
        # could be).
        from mpa_tpu_torch.ops.ball_query import ball_query_plain

        last = ball_query_plain(inp["radius"], ns, inp["xyz"], inp["new_xyz"])[..., -1].long()
        ops = int(torch.where(last < N, last + 1, N).sum()) * (2 * C + 3)
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
    elif name in ("scatter_mean_kernel", "windowed_scatter_mean_kernel"):
        B, S, C = inp["features"].shape
        K, N = inp["knn_idx"].shape[2], inp["num_fine"]
        nbytes = 4 * (B * S * C + B * S * K + B * N * C + B * N)
        # One add per float of every row that lands in a slot (this call's
        # indices, not the most there could be), one divide per output float.
        idx = inp["knn_idx"]
        ops = int(((idx >= 0) & (idx < N)).sum()) * C + B * N * C
    elif name in ("transition_attention_bwd_kernel", "windowed_attention_bwd_kernel"):
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
    the same inputs, for an exact or (with a ``spec``) a windowed search. The
    exact plain gradient comes from the expanded form |q|^2 + |b|^2 - 2 q.b,
    whose terms are of size |q| |g| and cancel, so the absolute floor scales
    with them."""
    from mpa_tpu_torch.ops.knn import knn, knn_plain
    from mpa_tpu_torch.ops.window import windowed_knn_plain, windowed_knn_with_spec

    k, base, query = inp["k"], inp["base"], inp["query"]
    fns = (knn, knn_plain)
    if "spec" in inp:
        fns = (lambda k, b, q: windowed_knn_with_spec(k, b, q)[:2],
               lambda k, b, q: windowed_knn_plain(k, b, q, inp["spec"]))
    weights = torch.linspace(0.5, 1.5, k, device=base.device)
    grads = []
    for fn in fns:
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


def check_scatter_mean_grad(inp: dict) -> float:
    """The scatter-mean's gradient on CUDA (``gather_rows_kernel`` on the
    gradient divided by the kernel's count) against torch autograd of the
    plain version on the same inputs. Both take one divide and a sum over K
    per entry, in another order: 1e-5 relative, 1e-6 absolute."""
    from mpa_tpu_torch.ops.scatter import scatter_mean_plain, scatter_mean_upsample
    from mpa_tpu_torch.ops.window import windowed_scatter_mean

    # A served request's tensors were made in inference mode; autograd saves
    # the index, so it takes a copy.
    feats, idx, n = inp["features"].detach(), inp["knn_idx"].clone(), inp["num_fine"]
    g = torch.randn((feats.shape[0], n, feats.shape[2]), device=feats.device,
                    generator=torch.Generator(device=feats.device).manual_seed(SEED))
    kern = scatter_mean_upsample
    if "spec" in inp:
        kern = lambda f, i, m: windowed_scatter_mean(f, i, m, inp["spec"])  # noqa: E731
    grads = []
    for fn in (kern, lambda f, i, m: scatter_mean_plain(f, i, m)[0]):
        f = feats.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(f, idx, n), f, g)[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    return (grads[0] - grads[1]).abs().max().item()


def check_call(name: str, inp: dict) -> dict:
    """Kernel against plain version on one recorded call, with its times."""
    # A backward launch records tensors that autograd saved; replay them
    # detached, so that the plain version builds no graph.
    inp = {k: v.detach() if torch.is_tensor(v) else v for k, v in inp.items()}
    from mpa_tpu_torch.ops.attention import (
        attention_bwd_cuda, attention_bwd_plain, attention_cuda, attention_fwd_form,
        attention_plain,
    )
    from mpa_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_form, ball_query_plain
    from mpa_tpu_torch.ops.fps import fps_chain_cuda, fps_cuda, fps_form, fps_plain
    from mpa_tpu_torch.ops.gather import (
        gather_cuda, gather_form, gather_plain, scatter_add_cuda, scatter_add_form,
        scatter_add_plain,
    )
    from mpa_tpu_torch.ops.knn import knn_cuda, knn_plain
    from mpa_tpu_torch.ops.scatter import scatter_mean_cuda, scatter_mean_form, scatter_mean_plain
    from mpa_tpu_torch.ops.window import (
        check_in_window, windowed_attention_bwd_cuda, windowed_attention_cuda, windowed_knn_cuda,
        windowed_knn_form, windowed_knn_plain, windowed_scatter_mean_cuda,
        windowed_scatter_mean_form,
    )

    library, ref, chain, spec, extra = None, None, None, inp.get("spec"), {}
    if spec is not None and name != "windowed_knn_kernel":
        check_in_window(inp["idx"] if "idx" in inp else inp["knn_idx"], spec, name)
    if name == "knn_kernel":
        k, base, query = inp["k"], inp["base"], inp["query"]
        kern, plain = (lambda: knn_cuda(k, base, query)), (lambda: knn_plain(k, base, query))
        library = lambda: torch.topk(torch.cdist(query, base), k, dim=-1, largest=False)  # noqa: E731
        (gd, gi), (wd, wi) = kern(), plain()
        if not torch.equal(gi, wi):
            raise AssertionError(f"knn_kernel indices differ from the plain version "
                                 f"at {int((gi != wi).sum())} places")
        if not torch.equal(gd, wd):
            raise AssertionError(f"knn_kernel distances differ from the plain version at "
                                 f"{int((gd != wd).sum())} places")
        err = 0.0
        shape = f"base {tuple(base.shape)} query {tuple(query.shape)} k={k}"
    elif name == "windowed_knn_kernel":
        k, base, query = inp["k"], inp["base"], inp["query"]
        kern = lambda: windowed_knn_cuda(k, base, query, spec)  # noqa: E731
        plain = lambda: windowed_knn_plain(k, base, query, spec)  # noqa: E731
        (gd, gi), (wd, wi) = kern(), plain()
        if not torch.equal(gi, wi):
            raise AssertionError(f"windowed_knn_kernel indices differ from the plain version "
                                 f"at {int((gi != wi).sum())} places")
        if not torch.equal(gd, wd):
            raise AssertionError("windowed_knn_kernel distances differ from the plain version")
        err = 0.0
        resident, par = windowed_knn_form(base.shape[0], base.shape[2], spec)
        shape = (f"base {tuple(base.shape)} query {tuple(query.shape)} k={k} window={spec.window}, "
                 + (f"resident form, {par} threads a query" if resident
                    else f"streaming form, {par} queries a thread"))
    elif name == "ball_query_kernel":
        args = (inp["radius"], inp["nsample"], inp["xyz"], inp["new_xyz"])
        kern, plain = (lambda: ball_query_cuda(*args)), (lambda: ball_query_plain(*args))
        got, want = kern(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"ball_query_kernel differs from the plain version at "
                                 f"{int((got != want).sum())} places")
        err = 0.0
        hits = (want < args[2].shape[1]).sum(-1).float()
        shape = (f"xyz {tuple(args[2].shape)} new_xyz {tuple(args[3].shape)} r={args[0]} "
                 f"nsample={args[1]}, hits per centre {hits.mean().item():.2f} "
                 f"(full {(hits == args[1]).float().mean().item():.3f}, centre alone "
                 f"{(hits == 1).float().mean().item():.3f}), "
                 f"{ball_query_form(args[2].shape[0], args[3].shape[1])} centres a warp")
    elif name == "fps_kernel":
        pts, npoint, start = inp["points"], inp["npoint"], inp["start"]
        kern, plain = (lambda: fps_cuda(pts, npoint, start)), (lambda: fps_plain(pts, npoint, start))
        got, want = kern(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"fps_kernel differs from the plain version at "
                                 f"{int((got != want).sum())} places")
        err = 0.0
        resident, cs, nw = fps_form(*pts.shape)
        shape = (f"points {tuple(pts.shape)} npoint={npoint}, "
                 f"{'resident' if resident else 'sliced'} form, cluster {cs}, {nw} warps")
        # The chain floor: the same launch with the distance work cut.
        chain = time_graph(lambda: fps_chain_cuda(pts, npoint, start))
    elif name == "gather_rows_kernel":
        pts, idx = inp["points"], inp["idx"]
        idx64 = idx.long()[..., None].expand(-1, -1, pts.shape[-1])
        kern, plain = (lambda: gather_cuda(pts, idx)), (lambda: gather_plain(pts, idx))
        library = lambda: torch.gather(pts, 1, idx64)  # noqa: E731
        got, want = kern(), plain()
        if not torch.equal(got, want):
            raise AssertionError("gather_rows_kernel differs from the plain version")
        err = 0.0
        shape = ("points {} idx {}, {} floats a column, {} columns a thread"
                 .format(tuple(pts.shape), tuple(idx.shape), *gather_form(pts, idx.numel())))
    elif name == "scatter_add_rows_kernel":
        grads, idx, n = inp["grads"], inp["idx"], inp["num_points"]
        B, _, W = grads.shape
        kern, plain = (lambda: scatter_add_cuda(grads, idx, n)), (lambda: scatter_add_plain(grads, idx, n))
        rows = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n).reshape(-1)
        flat_grads = grads.reshape(-1, W)
        library = lambda: torch.zeros((B * n, W), device=grads.device).index_add_(  # noqa: E731
            0, rows, flat_grads)
        got, again, want = kern(), kern(), plain()
        cpu = scatter_add_plain(grads.cpu(), idx.cpu(), n)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        if not torch.equal(got.cpu(), cpu):
            raise AssertionError(
                f"{name} differs from the plain version on the CPU at "
                f"{int((got.cpu() != cpu).sum())} places")
        # The plain version's index_add_ is atomic on the card: sums in another
        # order. The CPU comparison above is the exact one.
        err = assert_close_scaled(got, want, rtol=1e-5, what=name)
        ref = want.abs().max().item()
        shape = ("grads {} into N={}, {} slots a block, {} channels a lane"
                 .format(tuple(grads.shape), n, *scatter_add_form(grads, n)))
    elif name in ("scatter_mean_kernel", "windowed_scatter_mean_kernel"):
        feats, idx, n = inp["features"], inp["knn_idx"], inp["num_fine"]
        B, S, C = feats.shape
        K = idx.shape[2]
        kern = lambda: scatter_mean_cuda(feats, idx, n)  # noqa: E731
        if spec is not None:
            kern = lambda: windowed_scatter_mean_cuda(feats, idx, n, spec)  # noqa: E731
        plain = lambda: scatter_mean_plain(feats, idx, n)  # noqa: E731
        rows = (idx.long() + torch.arange(B, device=idx.device)[:, None, None] * n).reshape(-1)
        vals = feats[:, :, None, :].expand(B, S, K, C).reshape(-1, C)
        ones = torch.ones_like(rows, dtype=torch.float32)

        def index_adds():  # index_add_ of the rows and of ones, then the divide
            total = torch.zeros((B * n, C), device=feats.device).index_add_(0, rows, vals)
            cnt = torch.zeros((B * n,), device=feats.device).index_add_(0, rows, ones)
            return total / cnt.clamp_min(1.0)[:, None]

        rows_c = rows[:, None].expand(-1, C)
        library = lambda: torch.zeros((B * n, C), device=feats.device).scatter_reduce_(  # noqa: E731
            0, rows_c, vals, reduce="mean", include_self=False)

        (got, gc), (again, _), (want, wc) = kern(), kern(), plain()
        cpu, cc = scatter_mean_plain(feats.cpu(), idx.cpu(), n)
        if not (torch.equal(gc, wc) and torch.equal(gc.cpu(), cc)):
            raise AssertionError(f"{name}: the count differs from the plain version")
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        if not torch.equal(got.cpu(), cpu):
            raise AssertionError(
                f"{name} differs from the plain version on the CPU at "
                f"{int((got.cpu() != cpu).sum())} places")
        # The plain version's index_add_ is atomic on the card: a sum of up to a
        # few dozen rows in another order. The CPU comparison above is the exact one.
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = (got - want).abs().max().item()
        shape = f"features {tuple(feats.shape)} idx {tuple(idx.shape)} into N={n}"
        form = scatter_mean_form(feats, n) if spec is None else windowed_scatter_mean_form(feats, n)
        shape += ", {} slots a block, {} channels a lane".format(*form)
        extra["index_add_ms"] = time_graph(index_adds)
    elif name in ("transition_attention_bwd_kernel", "windowed_attention_bwd_kernel"):
        args = (inp["packed"], inp["idx"], inp["shifts"], inp["gctx"], inp["n_branches"], inp["c"])
        kern, plain = (lambda: attention_bwd_cuda(*args)), (lambda: attention_bwd_plain(*args))
        if spec is not None:
            kern = lambda: windowed_attention_bwd_cuda(*args, spec)  # noqa: E731
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
        if spec is not None:
            kern = lambda: windowed_attention_cuda(*args, spec)  # noqa: E731
        got, want = kern(), plain()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from the plain version at "
                                 f"{int((got != want).sum())} places")
        err = 0.0
        shape = (f"packed {tuple(args[0].shape)} idx {tuple(args[1].shape)} "
                 f"shift={args[2] is not None} n_branches={args[3]}, "
                 f"{attention_fwd_form(args[0], args[2], args[1].shape[2], args[4])} "
                 "channels a thread")
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
        "chain_floor_ms": chain,
        "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
        "ops_ms": ops / PEAK_F32_OPS_PER_S * 1e3,
    }
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row.update(extra)
    return row


def path_config(path: str, parity: bool = False):
    """The preset of ``path`` (a key of ``PATHS``) with the path's overrides
    and this script's seed; ``parity`` gives the card-against-CPU checks'
    cloud size where the path has one of its own."""
    from mpa_tpu_torch.configs import PRESETS

    spec = path_spec(path)
    cfg = PRESETS[spec["preset"]].with_overrides(seed=SEED, **spec.get("overrides", {}))
    if parity and "parity_points" in spec:
        cfg = cfg.with_overrides(num_points=spec["parity_points"])
    return cfg


def fresh_model(path: str, cfg=None, **kw):
    """The path's model (for ``cfg``, default its config) at its preset's
    width, with weights drawn from ``SEED``."""
    from mpa_tpu_torch.configs import model_kwargs
    from mpa_tpu_torch.models import get_model
    from mpa_tpu_torch.utils.init import init_like_flax

    cfg = cfg or path_config(path)
    model = get_model(cfg.model, **model_kwargs(cfg), **kw)
    return init_like_flax(model, torch.Generator().manual_seed(SEED))


def train_arrays(path: str, cfg):
    """The path's training set: the training CLI's synthetic one, but for
    repsurf ``surface_clouds``, whose radius-0.1 balls hold neighbours on
    the surface (the CLI's volume clouds leave most with their centre
    alone)."""
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.data import surface_clouds

    if path == "repsurf":
        return surface_clouds(cli_train.DATASET_SIZES["cls"][0], cfg.num_points,
                              cfg.num_classes, seed=0)
    return cli_train.load_dataset(cfg, n_eval=1)[0]


def make_step(path: str, steps_per_epoch: int):
    from mpa_tpu_torch.train import TRAIN_STEPS

    cfg = path_config(path)
    return TRAIN_STEPS[cfg.task](cfg, steps_per_epoch)


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


def fix_flips(model: torch.nn.Module, batch: int) -> None:
    """Hand a model with an umbrella constructor the same normal flips on
    every device: ``batch`` alternating signs (+1, -1, ...) passed to each
    forward, where the train step would draw them from the device's
    generator (a CUDA and a CPU generator draw different bits)."""
    if getattr(model, "surface_constructor", None) is None:
        return
    flips = torch.tensor([1.0 - 2.0 * (i % 2) for i in range(batch)])

    def hook(module, args, kwargs):
        return args, dict(kwargs, flips=flips.to(args[0].device))

    model.register_forward_pre_hook(hook, with_kwargs=True)


def train_parity(path: str) -> dict:
    """One step of the path's preset with dropout 0 on the card and on the
    CPU (plain ops), from the same weights, with the same umbrella flips
    (``fix_flips``), on the first ``parity_batch`` training clouds. Returns
    the loss difference, ``grad_error_units`` of the gradients, the worst
    error of a BatchNorm running statistic (relative to its norm plus 1e-3
    an entry) as ``(name, value)``, the card step's launch counts and both
    steps' wall seconds."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import create_train_state

    spec, cfg = path_spec(path), path_config(path, parity=True)
    arrays = train_arrays(path, cfg)
    head = tuple(a[:spec["parity_batch"]] for a in arrays)
    model = fresh_model(path, cfg, **({} if path == "completion" else {"dropout": 0.0}))
    fix_flips(model, spec["parity_batch"])
    results = {}
    for device in (torch.device("cuda"), torch.device("cpu")):
        state = create_train_state(copy.deepcopy(model), cfg, device)
        inputs, labels = cli_train.make_inputs(cfg, head, device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(make_step(path, len(arrays[0]) // spec["batch"])(state, inputs, labels))
        wall = time.perf_counter() - t0
        grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
        stats = {n: b.detach().cpu() for n, b in state.model.named_buffers() if "running" in n}
        results[device.type] = (loss, grads, stats, wall, dict(kernels.LAUNCHES))
    (lg, gg, sg, wg, launches), (lc, gc, sc, wc, _) = results["cuda"], results["cpu"]
    # Relative to the statistic's norm plus 1e-3 an entry: a running mean that
    # is zero up to rounding (a Dense with a zero bias on centred coordinates)
    # has no relative error to speak of.
    stat_err = {n: float((sg[n] - sc[n]).norm() / (sc[n].norm() + 1e-3 * sc[n].numel() ** 0.5))
                for n in sc}
    return {
        "loss_diff": abs(lg - lc),
        "grad_units": grad_error_units(gg, gc),
        "stat": max(stat_err.items(), key=lambda kv: kv[1]),
        "launches": {k: v for k, v in launches.items() if v},
        "cuda_s": wg,
        "cpu_s": wc,
    }


def check_launches(tag: str, launches: dict, per_unit: dict, units: int, unit: str) -> None:
    """Every kernel's count over ``units`` requests or steps is exactly
    ``per_unit``'s, and a kernel the path does not run was not launched."""
    for name, count in launches.items():
        if count != per_unit.get(name, 0) * units:
            raise AssertionError(f"{tag} {name}: {count} launches over {units} {unit}s, "
                                 f"want {per_unit.get(name, 0)} per {unit}")


def train_phase(path: str, tag: str) -> dict:
    """Phases 2b, 2d and 2f: the path's train step on the card, its launch
    counts, the loss on a fixed batch, the CUDA step against the CPU step,
    and the training CLI."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import create_train_state

    spec, cfg = PATHS[path], path_config(path)
    B, points = spec["batch"], spec["points"]
    arrays = train_arrays(path, cfg)
    steps_per_epoch = len(arrays[0]) // B
    cuda = torch.device("cuda")

    def batch(i):
        return cli_train.make_inputs(cfg, tuple(a[i * B:(i + 1) * B] for a in arrays), cuda)

    # Timed steps, with the launch counts of exactly those steps.
    state = create_train_state(fresh_model(path), cfg, cuda)
    step = make_step(path, steps_per_epoch)
    for i in range(TRAIN_WARMUP):
        step(state, *batch(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        x, y = batch(TRAIN_WARMUP + i)
        t0 = time.perf_counter()
        losses.append(float(step(state, x, y)))  # float() waits for the step
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"[{tag}] step {i}: B={B} x {points} pts, loss {loss:.4f}, "
            f"{dt * 1e3:.3f} ms, {B / dt:.1f} clouds/s")
    log(f"[{tag}] launches over {TRAIN_STEPS} steps: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    check_launches(tag, launches, spec["per_train_step"], TRAIN_STEPS, "train step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train losses {losses}")

    # One more step records the backward launches' inputs, and the step's
    # gathers (forward, and the scatter-means' backward), for phase 3.
    kernels.recorded = []
    step(state, *batch(TRAIN_WARMUP + TRAIN_STEPS))
    torch.cuda.synchronize()
    recorded = [(n, inp) for n, inp in kernels.recorded
                if n in BACKWARD or n == "gather_rows_kernel"]
    kernels.recorded = None
    del state

    # Ten steps on one fixed batch must lower the loss.
    state = create_train_state(fresh_model(path), cfg, cuda)
    step = make_step(path, steps_per_epoch)
    x, y = batch(0)
    fixed = [float(step(state, x, y)) for _ in range(FIXED_STEPS)]
    log(f"[{tag}] {FIXED_STEPS} steps on one batch: loss {fixed[0]:.4f} -> {fixed[-1]:.4f}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"the loss did not fall on a fixed batch: {fixed}")
    del state

    parity = train_parity(path)
    log(f"[{tag}] cuda vs cpu, one step at B={spec['parity_batch']} "
        f"({parity['cuda_s'] * 1e3:.1f} ms on the card, {parity['cpu_s']:.1f} s on the host): "
        f"loss |d| {parity['loss_diff']:.3e} (limit 1e-4); gradient error in units of "
        f"grad_error_units (limit {spec['grad_limit']}), largest: "
        + ", ".join(f"{n} {u:.3f}" for n, u in parity["grad_units"][:3])
        + f"; worst statistic {parity['stat'][0]} rel {parity['stat'][1]:.3e} (limit 1e-4)")
    if (not parity["loss_diff"] <= 1e-4 or parity["grad_units"][0][1] > spec["grad_limit"]
            or parity["stat"][1] > 1e-4):
        raise AssertionError(f"[{tag}] the CUDA train step differs from the CPU step")

    # The training CLI, in-process, its checkpoint in a directory of its own.
    with tempfile.TemporaryDirectory() as log_dir:
        out = cli_train.main(["--preset", spec["preset"], "--device", "cuda", "--max_steps", "3",
                              "--seed", str(SEED), "--log_dir", log_dir, *spec.get("cli", [])])
    if out["steps"] != 3 or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"cli.train: {out}")
    log(f"[{tag}] cli.train: 3 steps, losses {out['losses']}, eval "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items() if isinstance(v, float)))
    return {"launches": launches, "recorded": recorded,
            "step_ms": [t * 1e3 for t in times]}


def segmentation_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Two ``[B, N, P]`` log-prob tensors compared point by point: the
    largest difference over the parts at each point (its maximum, median and
    99th percentile over the points) and the share of points whose argmax
    agrees."""
    d = (got.float() - want.float()).abs().amax(-1).flatten()
    return {
        "max_abs": d.max().item(),
        "median_abs": d.median().item(),
        "p99_abs": torch.quantile(d, 0.99).item(),
        "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
    }


def semseg_parity(path: str = "semseg") -> dict:
    """``load_semantic_segmenter`` of ``path`` (``semseg``: window_all at the
    preset's 4096 points; ``s3dis``: exact) on the card against the CPU
    (plain ops) from the same weights on ``parity_batch`` 4096-point blocks:
    ``segmentation_agreement``, the CPU's seconds and every launch of the
    card request (``recorded``)."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.data import synthetic_semseg
    from mpa_tpu_torch.serve import load_semantic_segmenter

    spec = path_spec(path)
    points = spec.get("parity_points", spec["points"])
    kw = dict(seed=SEED, num_points=points,
              neighbor_mode=spec.get("overrides", {}).get("neighbor_mode", "exact"))
    blocks, _ = synthetic_semseg(1, points, seed=SEED)
    x = blocks[:spec["parity_batch"]]
    kernels.recorded = []
    try:
        got = load_semantic_segmenter(spec["preset"], **kw)(x).cpu()
    finally:
        recorded, kernels.recorded = kernels.recorded, None
    cpu = load_semantic_segmenter(spec["preset"], device="cpu", **kw)
    t0 = time.perf_counter()
    want = cpu(x)
    return dict(segmentation_agreement(got, want), cpu_s=time.perf_counter() - t0,
                recorded=recorded)


def segmenter_parity(batch: int = PATHS["partseg"]["parity_batch"],
                     preset: str = "shapenetpart", **overrides) -> dict:
    """``load_segmenter(preset, **overrides)`` on the card against the CPU
    (plain ops) from the same weights on ``batch`` synthetic clouds:
    ``segmentation_agreement``, the CPU's seconds, the inputs of the card
    request's ``gather_rows_kernel`` launches and all its launches
    (``recorded``)."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.data import realistic_partseg
    from mpa_tpu_torch.serve import load_segmenter

    pts, cats, _ = realistic_partseg(batch, PATHS["partseg"]["points"], seed=SEED)
    kernels.recorded = []
    try:
        got = load_segmenter(preset, seed=SEED, **overrides)(pts, cats).cpu()
    finally:
        recorded, kernels.recorded = kernels.recorded, None
    cpu = load_segmenter(preset, seed=SEED, device="cpu", **overrides)
    t0 = time.perf_counter()
    want = cpu(pts, cats)
    return dict(segmentation_agreement(got, want), cpu_s=time.perf_counter() - t0,
                gather=[inp for name, inp in recorded if name == "gather_rows_kernel"],
                recorded=recorded)


def cloud_requests(path: str, n: int) -> np.ndarray:
    """``n`` request clouds of the pose or completion path: the CLI's eval
    clouds (seed 1) in their served form, pose's rotated about z, completion's
    the half with the lowest x."""
    from mpa_tpu_torch.cli import train as cli_train

    cfg = path_config(path)
    return cli_train.load_dataset(cfg, n_train=1, n_eval=n)[1][0]


def serve_loader(path: str, device=None):
    """The serving entry point of ``path`` with this script's seed."""
    from mpa_tpu_torch.serve import (
        load_classifier, load_completer, load_pose_regressor, load_segmenter,
        load_semantic_segmenter,
    )

    spec = PATHS[path]
    loader = {"partseg": load_segmenter, "partseg_fp": load_segmenter,
              "semseg": load_semantic_segmenter, "pose": load_pose_regressor,
              "completion": load_completer}.get(path, load_classifier)
    return loader(spec["preset"], seed=SEED, device=device, **spec.get("overrides", {}))


def cloud_parity(path: str) -> dict:
    """The pose or completion loader on the card against the CPU (plain ops)
    from the same weights on ``parity_batch`` request clouds:
    ``segmentation_agreement`` of the rotations' nine entries or the coarse
    and fine clouds' points (largest difference over xyz), the CPU's
    seconds, and every launch of the card request (``recorded``)."""
    from mpa_tpu_torch import kernels

    x = cloud_requests(path, PATHS[path]["parity_batch"])
    kernels.recorded = []
    try:
        got = serve_loader(path)(x)
    finally:
        recorded, kernels.recorded = kernels.recorded, None
    cpu = serve_loader(path, device="cpu")
    t0 = time.perf_counter()
    want = cpu(x)
    if path == "pose":
        got, want = got.cpu().reshape(1, -1, 9), want.reshape(1, -1, 9)
    else:
        got, want = (torch.cat([t[0], t[1]], 1) for t in ((got[0].cpu(), got[1].cpu()), want))
    return dict(segmentation_agreement(got, want), cpu_s=time.perf_counter() - t0,
                recorded=recorded)


def check_served_output(path: str, out, B: int, points: int) -> None:
    """A served answer of ``path``: log-probs of the right shape whose rows
    sum to 1; rotations (orthonormal, determinant 1); or the coarse and fine
    clouds, finite."""
    cfg = path_config(path)
    if path == "pose":
        eye = torch.eye(3, device=out.device).expand(B, 3, 3)
        if tuple(out.shape) != (B, 3, 3) or not torch.isfinite(out).all():
            raise AssertionError(f"[{path}] bad rotations {tuple(out.shape)}")
        torch.testing.assert_close(out @ out.transpose(1, 2), eye, rtol=0, atol=1e-4)
        torch.testing.assert_close(torch.linalg.det(out), eye[:, 0, 0], rtol=0, atol=1e-4)
        return
    if path == "completion":
        coarse, fine = out
        want = ((B, 256, 3), (B, points + 1024, 3))
        if (tuple(coarse.shape), tuple(fine.shape)) != want or not (
                torch.isfinite(coarse).all() and torch.isfinite(fine).all()):
            raise AssertionError(f"[{path}] bad clouds {tuple(coarse.shape)} {tuple(fine.shape)}")
        return
    if path in ("partseg", "partseg_fp", "semseg"):
        shape = (B, points, cfg.num_parts if path.startswith("partseg") else cfg.num_classes)
    else:
        shape = (B, cfg.num_classes)
    if tuple(out.shape) != shape or not torch.isfinite(out).all():
        raise AssertionError(f"[{path}] bad output {tuple(out.shape)}")
    torch.testing.assert_close(out.exp().sum(-1), torch.ones(shape[:-1], device=out.device),
                               rtol=0, atol=1e-4)


def serve_phase(path: str, tag: str) -> dict:
    """Phases 2, 2c, 2e, 2g, 2i, 2k and 2m: the path's serving entry point
    answers two warm-up and ``REQUESTS`` timed requests on the card; launch
    counts, well-formed answers, and the card against the CPU."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.data import realistic_partseg, surface_clouds, synthetic_semseg

    spec = PATHS[path]
    B, points = spec["batch"], spec["points"]
    serve = serve_loader(path)
    if path == "semseg":
        blocks, _ = synthetic_semseg(1, points, seed=SEED)  # 24 blocks of one room
        requests = [(blocks[i * B:(i + 1) * B],) for i in range(REQUESTS + 1)]
    elif path in ("partseg", "partseg_fp"):
        pts, cats, _ = realistic_partseg(B * (REQUESTS + 1), points, seed=SEED)
        requests = [(pts[i * B:(i + 1) * B], cats[i * B:(i + 1) * B])
                    for i in range(REQUESTS + 1)]
    elif path == "repsurf":
        pts, _ = surface_clouds(B * (REQUESTS + 1), points, seed=SEED)
        requests = [(pts[i * B:(i + 1) * B],) for i in range(REQUESTS + 1)]
    elif path in ("pose", "completion"):
        pts = cloud_requests(path, B * (REQUESTS + 1))
        requests = [(pts[i * B:(i + 1) * B],) for i in range(REQUESTS + 1)]
    else:
        rng = np.random.default_rng(SEED)
        requests = [(rng.standard_normal((B, points, 3)).astype(np.float32),)
                    for _ in range(REQUESTS + 1)]
    for _ in range(2):  # warm-up: kernel loading, allocator growth
        serve(*requests[0])
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    outputs, latencies = [], []
    for req in requests[1:]:
        t0 = time.perf_counter()
        out = serve(*req)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        outputs.append(out)
    launches = dict(kernels.LAUNCHES)

    # One more request of the same shapes records every kernel's inputs for
    # phase 3 (recording keeps them alive, so it stays out of the timed ones).
    kernels.recorded = []
    serve(*requests[1])
    recorded, kernels.recorded = kernels.recorded, None

    for i, lat in enumerate(latencies):
        log(f"[{tag}] request {i}: B={B} x {points} pts, {lat * 1e3:.3f} ms, "
            f"{B / lat:.1f} clouds/s")
    log(f"[{tag}] launches over {REQUESTS} requests: {launches}")
    check_launches(tag, launches, spec["per_forward"], REQUESTS, "request")
    for out in outputs:
        check_served_output(path, out, B, points)
    if path in ("partseg", "partseg_fp", "semseg", "pose", "completion"):
        if path == "semseg":
            report, limits = semseg_parity(), SEMSEG_LIMITS
        elif path.startswith("partseg"):
            report, limits = segmenter_parity(preset=spec["preset"]), SEG_LIMITS
        else:
            report, limits = cloud_parity(path), CLOUD_LIMITS
        log(f"[{tag}] cuda vs cpu at B={spec['parity_batch']} x "
            f"{spec.get('parity_points', points)} pts (plain ops, {report['cpu_s']:.1f} s on the "
            f"host): per point max |d| over its entries: median {report['median_abs']:.3e}, "
            f"99th percentile {report['p99_abs']:.3e}, max {report['max_abs']:.3e}; argmax "
            f"agreement {report['argmax_agreement']:.5f} (limits {limits})")
        if not within(report, limits):
            raise AssertionError(f"[{tag}] cuda and cpu answers differ: {report}")
    else:
        cpu = serve_loader(path, device="cpu")
        t0 = time.perf_counter()
        want = cpu(*requests[1])
        t_cpu = time.perf_counter() - t0
        got = outputs[0].cpu()
        diff = (got - want).abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"[{tag}] cuda vs cpu (plain ops, {t_cpu:.1f} s on the host): max |dlogp| = "
            f"{diff:.3e} (limit 1e-3), argmax agreement {agree:.4f}")
        if not diff <= 1e-3:
            raise AssertionError(f"[{tag}] cuda and cpu log-probs differ by {diff}")
    return {"launches": launches, "recorded": recorded,
            "latency_ms": [t * 1e3 for t in latencies]}


def within(report: dict, limits: dict) -> bool:
    """Every reading of ``limits`` in ``report`` within it: the ``*_abs``
    ones at most, the others (agreements) at least."""
    return all(report[k] <= v if k.endswith("_abs") else report[k] >= v
               for k, v in limits.items())


def replay_call(path: str, name: str, inp: dict) -> dict:
    """``check_call`` on one recorded launch, logged, tagged with ``path``."""
    row = dict(check_call(name, inp), path=path)
    lib = "null" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    ref = "" if row["max_abs_ref"] is None else f" (of max |ref| {row['max_abs_ref']:.3e})"
    chain = "" if row["chain_floor_ms"] is None else f", chain floor {row['chain_floor_ms']:.4f} ms"
    if "index_add_ms" in row:
        chain += f", index_add_ x2 + divide {row['index_add_ms']:.4f} ms"
    log(f"[3 {path}] {name} {row['shape']}: max_abs_err {row['max_abs_err']:.3e}{ref}, "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {lib} ms, "
        f"bound {row['bound_ms']:.4f} ms{chain}")
    return row


def fps_16384_phase() -> list:
    """One request of ``markov_semseg`` in the ``window`` mode at 16384
    points, B = 2 ``synthetic_semseg`` blocks, on the card: its exact FPS
    runs ``fps_kernel`` over 16384 points, and its feature searches stay
    exact (``knn_kernel``). The log-probs must be finite, and every such FPS
    launch and every ``knn_kernel`` launch is replayed against its plain
    version."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.data import synthetic_semseg
    from mpa_tpu_torch.serve import load_semantic_segmenter

    serve = load_semantic_segmenter(PATHS["semseg"]["preset"], seed=SEED, num_points=16384,
                                    neighbor_mode="window")
    blocks, _ = synthetic_semseg(1, 16384, seed=SEED)
    kernels.recorded = []
    out = serve(blocks[:2])
    torch.cuda.synchronize()
    recorded, kernels.recorded = kernels.recorded, None
    if tuple(out.shape) != (2, 16384, 13) or not torch.isfinite(out).all():
        raise AssertionError(f"[2h semseg window 16384] bad output {tuple(out.shape)}")
    rows = [replay_call("semseg_window_16384", name, inp) for name, inp in recorded
            if name == "fps_kernel" and inp["points"].shape[1] == 16384]
    if not rows:
        raise AssertionError("no fps_kernel launch over 16384 points in the window mode")
    knn_rows = [replay_call("semseg_window_16384", name, inp) for name, inp in recorded
                if name == "knn_kernel"]
    if not knn_rows:
        raise AssertionError("no knn_kernel launch in the window mode's request")
    return rows + knn_rows


def partseg_window_phase(mode: str, tag: str) -> dict:
    """Phase 2o: ``load_segmenter(neighbor_mode=mode)`` (``markov_partseg``
    in a Morton-window mode) answers two warm-up and ``REQUESTS`` timed
    requests of 32 clouds x 2048 points on the card, its launch counts
    exactly ``PARTSEG_WINDOW_FORWARD[mode]`` a request; well-formed
    log-probs; the card against the CPU at B = 4 within ``SEG_LIMITS``;
    every launch of one more request replayed (phase 3, tagged
    ``partseg_MODE``)."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.data import realistic_partseg
    from mpa_tpu_torch.serve import load_segmenter

    spec = PATHS["partseg"]
    B, points = spec["batch"], spec["points"]
    serve = load_segmenter(spec["preset"], seed=SEED, neighbor_mode=mode)
    pts, cats, _ = realistic_partseg(B * (REQUESTS + 1), points, seed=SEED)
    requests = [(pts[i * B:(i + 1) * B], cats[i * B:(i + 1) * B]) for i in range(REQUESTS + 1)]
    for _ in range(2):
        serve(*requests[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    latencies = []
    for req in requests[1:]:
        t0 = time.perf_counter()
        out = serve(*req)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        check_served_output("partseg", out, B, points)
    launches = dict(kernels.LAUNCHES)
    kernels.recorded = []
    serve(*requests[1])
    recorded, kernels.recorded = kernels.recorded, None
    for i, lat in enumerate(latencies):
        log(f"[{tag}] request {i}: B={B} x {points} pts, {lat * 1e3:.3f} ms, "
            f"{B / lat:.1f} clouds/s")
    log(f"[{tag}] launches over {REQUESTS} requests: {launches}")
    check_launches(tag, launches, PARTSEG_WINDOW_FORWARD[mode], REQUESTS, "request")
    report = segmenter_parity(preset=spec["preset"], neighbor_mode=mode)
    log(f"[{tag}] cuda vs cpu at B={spec['parity_batch']} x {points} pts (plain ops, "
        f"{report['cpu_s']:.1f} s on the host): per point max |dlogp|: median "
        f"{report['median_abs']:.3e}, 99th percentile {report['p99_abs']:.3e}, max "
        f"{report['max_abs']:.3e}; argmax agreement {report['argmax_agreement']:.5f} "
        f"(limits {SEG_LIMITS})")
    if not within(report, SEG_LIMITS):
        raise AssertionError(f"[{tag}] cuda and cpu log-probs differ: {report}")
    rows = replay(f"partseg_{mode}", {"recorded": recorded}, {"recorded": []})
    return {"launches": launches, "latency_ms": [t * 1e3 for t in latencies], "rows": rows}


# Phase 6, the S3DIS scene path: rooms of ``[N, 7]`` rows (xyz uniform in
# the room's box, 2.5 m high, rgb, the label from three height bands):
# (x extent m, y extent m, points). Areas 1 and 2 train (32 blocks each),
# Area 5 is the test split (16 blocks) and the room of the scene inference:
# a million points, about what a real S3DIS room holds.
S3DIS_ROOMS = {"Area_1_office_1": (4.0, 3.0, 48000), "Area_2_office_1": (3.5, 3.0, 42000),
               "Area_5_office_1": (8.0, 6.0, 1_000_000)}
# The card-against-CPU scene: a 1.3 m x 1.3 m room of 4000 points in
# 1024-point blocks (nine columns; the plain ops take seconds a 4096-point
# block on the host).
SCENE_PARITY_ROOM, SCENE_PARITY_POINTS = (1.3, 1.3, 4000), 1024


def write_room(path: Path, sx: float, sy: float, n: int, seed: int) -> None:
    """One S3DIS room file: ``n`` rows of xyz uniform in ``sx`` x ``sy`` x
    2.5 m, rgb in [0, 255] and the label of three height bands."""
    r = np.random.default_rng(seed)
    xyz = r.uniform(0.0, 1.0, (n, 3)) * np.array([sx, sy, 2.5])
    label = np.digitize(xyz[:, 2], [0.8, 1.7])
    np.save(path, np.column_stack([xyz, r.uniform(0.0, 255.0, (n, 3)), label]).astype(np.float32))


class FirstLaunches(list):
    """A ``kernels.recorded`` list that keeps only the first ``n`` launches
    (one train step or one batch of a longer run)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n

    def append(self, item) -> None:
        if len(self) < self.n:
            super().append(item)


def s3dis_phase(tag: str, work: Path) -> dict:
    """Phase 6: ``cli.train --preset s3dis_semseg --dataset s3dis`` takes
    ``RECIPE_STEPS`` steps (B = 16 blocks of 4096 points, exact mode) and
    its eval on a room tree written here, its launches exactly those steps'
    and the eval's forwards; ``scene_inference`` over the Area 5 room
    through ``load_semantic_segmenter`` on the card (4096-point blocks,
    batches of 8), its launches exactly its batches' forwards, and the
    same scene with a forward that returns zeros (its host part); the served
    log-probs of one 4096-point block and one train step at B = 1 on the
    card against the CPU (plain ops; ``SEMSEG_LIMITS``, the path's
    ``grad_limit``); the scene of ``SCENE_PARITY_ROOM`` on the card and on
    the CPU, their per-point labels agreeing within ``SEMSEG_LIMITS``'
    argmax share; and every launch of the run's first train step and of the
    scene's first batch replayed (phase 3, tagged ``s3dis``)."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.data import s3dis
    from mpa_tpu_torch.serve import load_semantic_segmenter

    root = work / "s3dis_rooms"
    root.mkdir()
    t0 = time.perf_counter()
    for i, (name, (sx, sy, n)) in enumerate(S3DIS_ROOMS.items()):
        write_room(root / f"{name}.npy", sx, sy, n, seed=SEED + i)
    log(f"[{tag}] wrote {len(S3DIS_ROOMS)} rooms ({', '.join(S3DIS_ROOMS)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    data = ["--preset", "s3dis_semseg", "--dataset", "s3dis", "--data_root", str(root),
            "--log_dir", str(work / "s3dis_runs"), "--device", "cuda"]
    kernels.reset_launch_counts()
    kernels.recorded = FirstLaunches(sum(S3DIS_PATH["per_train_step"].values()))
    try:
        _, out = cli_train.run(cli_train.parse_args(
            data + ["--max_steps", str(RECIPE_STEPS), "--seed", str(SEED)]))
        torch.cuda.synchronize()
    finally:
        step_recorded, kernels.recorded = kernels.recorded, None
    train_launches = dict(kernels.LAUNCHES)
    cfg = cli_train.config_from_args(cli_train.parse_args(data))
    n_test = cli_train.S3DIS_BLOCKS[1] * len(s3dis.list_rooms(str(root), split="test"))
    batches = -(-n_test // cfg.batch_size)
    want = {k: RECIPE_STEPS * S3DIS_PATH["per_train_step"].get(k, 0)
            + batches * S3DIS_PATH["per_forward"].get(k, 0) for k in kernels.KERNELS}
    log(f"[{tag}] cli.train: {out['steps']} steps at B={cfg.batch_size} x {cfg.num_points} "
        f"pts, losses {out['losses']}, step ms {out['step_ms']}; eval block-mIoU "
        f"{out['block_miou']:.4f}, point acc {out['point_acc']:.4f} over {n_test} blocks; "
        f"launches {train_launches}")
    check_launches(f"{tag} train", train_launches, want, 1, "run")
    if out["steps"] != RECIPE_STEPS or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"[{tag}] cli.train: {out}")

    # The whole Area 5 room through the served segmenter on the card.
    xyzrgb, labels = s3dis.load_room(str(root / "Area_5_office_1.npy"))
    seg = load_semantic_segmenter(seed=SEED)
    n_points, n_blocks = len(xyzrgb), sum(1 for _ in s3dis.sliding_blocks(xyzrgb, cfg.num_points))
    kernels.reset_launch_counts()
    kernels.recorded = FirstLaunches(sum(S3DIS_PATH["per_forward"].values()))
    t0 = time.perf_counter()
    try:
        pred = s3dis.scene_inference(lambda x: seg(x).cpu().numpy(), xyzrgb, cfg.num_points,
                                     batch_size=8)
    finally:
        batch_recorded, kernels.recorded = kernels.recorded, None
    scene_s = time.perf_counter() - t0
    scene_launches = dict(kernels.LAUNCHES)
    check_launches(f"{tag} scene", scene_launches, S3DIS_PATH["per_forward"], -(-n_blocks // 8),
                   "batch")
    # Its host part: the same scene with a forward that returns zeros.
    t0 = time.perf_counter()
    s3dis.scene_inference(lambda x: np.zeros((len(x), cfg.num_points, cfg.num_classes),
                                             np.float32), xyzrgb, cfg.num_points, batch_size=8)
    host_s = time.perf_counter() - t0
    miou, acc, _ = s3dis.semseg_iou(pred, labels, cfg.num_classes)
    if pred.shape != labels.shape or pred.min() < 0 or pred.max() >= cfg.num_classes:
        raise AssertionError(f"[{tag}] scene labels {pred.shape} in [{pred.min()}, {pred.max()}]")
    log(f"[{tag}] scene inference of Area_5_office_1 ({n_points} points, {n_blocks} blocks "
        f"of {cfg.num_points}, batches of 8): {scene_s:.3f} s, {n_points / scene_s:.1f} "
        f"room points/s ({host_s:.3f} s with a forward that returns zeros: the host's "
        f"part); mIoU {miou:.4f}, acc {acc:.4f} (random weights); launches {scene_launches}")

    # The card's scene against the CPU's on a small room.
    sx, sy, n = SCENE_PARITY_ROOM
    write_room(work / "scene_parity.npy", sx, sy, n, seed=SEED + 10)
    xyzrgb, _ = s3dis.load_room(str(work / "scene_parity.npy"))
    kw = dict(seed=SEED, num_points=SCENE_PARITY_POINTS)
    gpu, cpu = load_semantic_segmenter(**kw), load_semantic_segmenter(device="cpu", **kw)
    card = s3dis.scene_inference(lambda x: gpu(x).cpu().numpy(), xyzrgb, SCENE_PARITY_POINTS)
    t0 = time.perf_counter()
    want = s3dis.scene_inference(lambda x: cpu(x).numpy(), xyzrgb, SCENE_PARITY_POINTS)
    agree = float(np.mean(card == want))
    log(f"[{tag}] scene card vs cpu ({n} points in {SCENE_PARITY_POINTS}-point blocks, plain ops "
        f"{time.perf_counter() - t0:.1f} s on the host): label agreement {agree:.5f} "
        f"({int((card != want).sum())} points differ; limit {SEMSEG_LIMITS['argmax_agreement']})")
    if agree < SEMSEG_LIMITS["argmax_agreement"]:
        raise AssertionError(f"[{tag}] the card's scene labels differ from the CPU's")

    # The exact model at the path's own 4096 points on the card against the CPU.
    report = semseg_parity("s3dis")
    log(f"[{tag}] served cuda vs cpu at B={S3DIS_PATH['parity_batch']} x "
        f"{S3DIS_PATH['points']} pts, exact (plain ops, {report['cpu_s']:.1f} s on the host): "
        f"per point max |dlogp|: median {report['median_abs']:.3e}, 99th percentile "
        f"{report['p99_abs']:.3e}, max {report['max_abs']:.3e}; argmax agreement "
        f"{report['argmax_agreement']:.5f} (limits {SEMSEG_LIMITS})")
    if not within(report, SEMSEG_LIMITS):
        raise AssertionError(f"[{tag}] cuda and cpu log-probs differ: {report}")
    parity = train_parity("s3dis")
    log(f"[{tag}] cuda vs cpu, one step at B={S3DIS_PATH['parity_batch']} x "
        f"{S3DIS_PATH['points']} pts ({parity['cuda_s'] * 1e3:.1f} ms on the card, "
        f"{parity['cpu_s']:.1f} s on the host): loss |d| {parity['loss_diff']:.3e} (limit 1e-4); "
        f"gradient error in units of grad_error_units (limit {S3DIS_PATH['grad_limit']}), "
        "largest: " + ", ".join(f"{n} {u:.3f}" for n, u in parity["grad_units"][:3])
        + f"; worst statistic {parity['stat'][0]} rel {parity['stat'][1]:.3e} (limit 1e-4)")
    check_launches(f"{tag} parity step", parity["launches"], S3DIS_PATH["per_train_step"], 1,
                   "train step")
    if (not parity["loss_diff"] <= 1e-4 or parity["grad_units"][0][1] > S3DIS_PATH["grad_limit"]
            or parity["stat"][1] > 1e-4):
        raise AssertionError(f"[{tag}] the CUDA train step differs from the CPU step")

    # Every launch of the run's first train step and of the scene's first batch.
    if len(step_recorded) != step_recorded.n or len(batch_recorded) != batch_recorded.n:
        raise AssertionError(f"[{tag}] recorded {len(step_recorded)} and {len(batch_recorded)} "
                             f"launches, want {step_recorded.n} and {batch_recorded.n}")
    rows = replay("s3dis", {"recorded": list(batch_recorded)}, {"recorded": list(step_recorded)})
    return {"train": train_launches, "scene": scene_launches, "step_ms": out["step_ms"],
            "scene_s": scene_s, "scene_host_s": host_s, "scene_points": n_points,
            "label_agreement": agree, "rows": rows}


def replay(path: str, served: dict, trained: dict) -> list:
    """Phase 3 for one model: every recorded launch against its plain
    version (a train step's gathers tagged ``PATH_train``), the kNN distance
    gradient and its gathers (tagged ``PATH_knn_grad``), and the
    scatter-mean's backward."""
    from mpa_tpu_torch import kernels

    rows = [replay_call(path, name, inp) for name, inp in served["recorded"]]
    rows += [replay_call(path if name in BACKWARD else f"{path}_train", name, inp)
             for name, inp in trained["recorded"]]
    # repsurf's one kNN (the umbrella's, on coordinates) keeps only indices.
    knn_feature = next((inp for name, inp in served["recorded"]
                        if name in ("knn_kernel", "windowed_knn_kernel")
                        and inp["base"].shape[-1] > 3), None)
    if knn_feature is not None:
        kernels.recorded = []
        try:
            err = check_knn_grad(knn_feature)
        finally:
            recorded, kernels.recorded = kernels.recorded, None
        rows += [replay_call(f"{path}_knn_grad", name, inp) for name, inp in recorded
                 if name == "gather_rows_kernel"]
        log(f"[3 {path}] knn distance gradient (gather_rows_kernel + scatter_add_rows_kernel) "
            f"base {tuple(knn_feature['base'].shape)} query {tuple(knn_feature['query'].shape)}"
            f"{' windowed' if 'spec' in knn_feature else ''}: max_abs_err {err:.3e} against "
            f"autograd of the plain kNN")
    errs = [check_scatter_mean_grad(inp) for name, inp in served["recorded"]
            if name in ("scatter_mean_kernel", "windowed_scatter_mean_kernel")]
    if errs:
        log(f"[3 {path}] scatter-mean backward (gather_rows_kernel) at {len(errs)} recorded "
            f"launches: max_abs_err {max(errs):.3e} against autograd of the plain version")
    return rows


def summarise(name: str, rows: list, counts: dict) -> dict:
    """One kernel's entry of the ``kernels`` line. Times are sums over the
    launches of one served request (forward kernels) or one train step
    (backward kernels); the top-level ones are those of the kernel's own
    path (markov_semseg window_all for the windowed kernels, repsurf_ssg_2x
    for the ball query, markov_partseg for the others), and ``by_path`` has
    each model's; ``other_replays`` the replays of launches outside the
    timed requests (FPS and the exact kNNs of the 16384-point window request,
    a train step's gathers, the kNN distance gradient's gathers).
    ``launches`` is the count in the timed run of that path the times are
    per (3 requests or 5 steps); ``launches_by_path`` has every counted
    run: each path's served requests and train steps, the window-mode
    requests, phase 5's and phase 6's runs."""
    backward = name in BACKWARD
    main = ("semseg" if name.startswith("windowed_")
            else "repsurf" if name == "ball_query_kernel" else "partseg")

    def sums(mine):
        if not mine:
            return None
        bytes_ms = sum(r["bytes_ms"] for r in mine)
        ops_ms = sum(r["ops_ms"] for r in mine)
        libs = [r["library_ms"] for r in mine]
        return {
            "launches_per_unit": len(mine),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "max_abs_ref": max(r["max_abs_ref"] for r in mine) if backward else None,
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if None in libs else sum(libs),
            **({"chain_floor_ms": sum(r["chain_floor_ms"] for r in mine)}
               if name == "fps_kernel" else {}),
            **({"index_add_ms": sum(r["index_add_ms"] for r in mine)}
               if "index_add_ms" in mine[0] else {}),
        }

    by_path = {path: sums([r for r in rows if r["name"] == name and r["path"] == path])
               for path in PATHS}
    source, replaces = SOURCES[name]
    entry = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": counts[f"{main}_train" if backward else f"{main}_serve"][name],
        "per": "train step" if backward else "request",
        "path": main,
        "launches_by_path": {run: c[name] for run, c in counts.items()},
        **by_path[main],
        "by_path": by_path,
    }
    if name in ALSO_REPLACES:
        entry["also_replaces"] = ALSO_REPLACES[name]
    others = {r["path"] for r in rows if r["name"] == name and r["path"] not in PATHS}
    if others:
        entry["other_replays"] = {
            p: dict(sums([r for r in rows if r["name"] == name and r["path"] == p]),
                    shape=next(r["shape"] for r in rows if r["name"] == name and r["path"] == p))
            for p in sorted(others)}
    return entry


# Phase 5: the published recipe through the entry points a user calls, on
# data trees written in the datasets' own formats. A train split of three
# batches, so that ``--max_steps 3`` is one epoch, one eval and one
# checkpoint, the state the trained model ends in.
RECIPE = {
    "cls": dict(preset="modelnet40_cls", dataset="modelnet40", train=192, test=64),
    "partseg": dict(preset="shapenetpart", dataset="shapenetpart", train=96, test=32),
}
RECIPE_VOTES, RECIPE_REPEATS, RECIPE_STEPS = 3, 2, 3


def write_modelnet_tree(root: Path, n_train: int, n_test: int, points: int) -> None:
    """A ModelNet40 tree: the class list, the split lists and one
    comma-separated xyz + normal text file of ``points`` rows a shape, made
    from ``synthetic_clouds`` over the 40 classes."""
    from mpa_tpu_torch.data import synthetic_clouds

    names = [f"class{c:02d}" for c in range(40)]
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    pts, labels = synthetic_clouds(n_train + n_test, points, 40, seed=SEED)
    normals = np.random.default_rng(SEED).standard_normal(pts.shape).astype(np.float32)
    ids = []
    for i, (p, n, c) in enumerate(zip(pts, normals, labels)):
        (root / names[c]).mkdir(exist_ok=True)
        ids.append(f"{names[c]}_{i:04d}")
        np.savetxt(root / names[c] / f"{ids[-1]}.txt", np.concatenate([p, n], -1),
                   fmt="%.6f", delimiter=",")
    (root / "modelnet40_train.txt").write_text("\n".join(ids[:n_train]) + "\n")
    (root / "modelnet40_test.txt").write_text("\n".join(ids[n_train:]) + "\n")


def write_shapenet_tree(root: Path, n_train: int, n_test: int, points: int) -> None:
    """A ShapeNetPart tree: ``synsetoffset2category.txt``, the shuffled split
    lists (a quarter of the train clouds in ``val``) and one ``x y z nx ny nz
    seg`` text file of ``points`` rows a shape, made from
    ``realistic_partseg``, whose labels lie in their category's block."""
    from mpa_tpu_torch.data.shapenetpart import CATEGORIES, SEG_PARTS
    from mpa_tpu_torch.data import realistic_partseg

    synsets = [f"{9000000 + c:08d}" for c in range(len(CATEGORIES))]
    (root / "synsetoffset2category.txt").write_text(
        "".join(f"{name}\t{syn}\n" for name, syn in zip(CATEGORIES, synsets)))
    pts, cats, segs = realistic_partseg(n_train + n_test, points, seed=SEED)
    if not all(np.isin(s, SEG_PARTS[c]).all() for s, c in zip(segs, cats)):
        raise AssertionError("realistic_partseg gave a label outside its category's block")
    normals = np.random.default_rng(SEED).standard_normal(pts.shape).astype(np.float32)
    lists = {"train": [], "val": [], "test": []}
    for i, (p, n, c, s) in enumerate(zip(pts, normals, cats, segs)):
        syn = synsets[c]
        (root / syn).mkdir(exist_ok=True)
        np.savetxt(root / syn / f"shape{i:04d}.txt", np.column_stack([p, n, s]), fmt="%.6f")
        split = "test" if i >= n_train else ("val" if i % 4 == 3 else "train")
        lists[split].append(f"shape_data/{syn}/shape{i:04d}")
    (root / "train_test_split").mkdir()
    for split, names in lists.items():
        (root / "train_test_split" / f"shuffled_{split}_file_list.json").write_text(
            json.dumps(names))


def recipe_phase(path: str, tag: str, work: Path) -> dict:
    """Phase 5 for ``path``: ``cli.train`` three steps on its data tree with
    the launch counts read, the checkpoint restored weights only into a
    fresh model on the card and held bit for bit against the trained model,
    ``cli.eval --checkpoint`` with its launch counts, and the vote pool of a
    test batch on the card against the CPU with the same weights and
    scales."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import eval as cli_eval
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.data import native_available
    from mpa_tpu_torch.train import BestCheckpointer, make_eval_step, vote_predict
    from mpa_tpu_torch.train.votes import draw_vote_scales

    spec, rec = PATHS[path], RECIPE[path]
    root, log_dir = work / f"{path}_data", work / f"{path}_runs"
    root.mkdir()
    t0 = time.perf_counter()
    writer = write_modelnet_tree if path == "cls" else write_shapenet_tree
    writer(root, rec["train"], rec["test"], spec["points"])
    log(f"[{tag}] wrote {rec['dataset']} tree: {rec['train']} train and {rec['test']} test "
        f"clouds of {spec['points']} points in {time.perf_counter() - t0:.1f} s")
    data = ["--preset", rec["preset"], "--dataset", rec["dataset"], "--data_root", str(root),
            "--log_dir", str(log_dir), "--device", "cuda"]

    kernels.reset_launch_counts()
    state, out = cli_train.run(cli_train.parse_args(
        data + ["--max_steps", str(RECIPE_STEPS), "--seed", str(SEED)]))
    torch.cuda.synchronize()
    train_launches = dict(kernels.LAUNCHES)
    cfg = cli_train.config_from_args(cli_train.parse_args(data))
    batches = -(-rec["test"] // cfg.batch_size)
    votes = cfg.num_votes if path == "cls" else 1  # the train eval of part-seg is one pass
    want = {k: RECIPE_STEPS * spec["per_train_step"].get(k, 0)
            + votes * batches * spec["per_forward"].get(k, 0) for k in kernels.KERNELS}
    log(f"[{tag}] cli.train ({'native' if native_available() else 'numpy'} text parser): "
        f"{out['steps']} steps, losses {out['losses']}, step ms {out['step_ms']}, "
        f"augmented mean |d| of the first batch {out['aug_delta']}; launches {train_launches}")
    check_launches(f"{tag} train", train_launches, want, 1, "run")
    if out["steps"] != RECIPE_STEPS or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"[{tag}] cli.train: {out}")
    if (path == "partseg") != (out["aug_delta"] is not None and out["aug_delta"] > 0):
        raise AssertionError(f"[{tag}] augmentation {out['aug_delta']}: part-seg's recipe "
                             "scales and shifts, cls's does not")
    ckpt_dir = cli_train.checkpoint_dir(cfg, rec["preset"])

    # The checkpoint, weights only, in a fresh model: bit for bit the trained one.
    _, test = cli_train.load_dataset(cfg)
    inputs, _ = cli_train.make_inputs(cfg, tuple(a[:cfg.batch_size] for a in test),
                                      torch.device("cuda"))
    fresh = cli_eval.eval_state(cfg, torch.device("cuda"))
    BestCheckpointer(ckpt_dir).restore(fresh, restore_optimizer=False)
    eval_step = make_eval_step()
    got, trained = eval_step(fresh, inputs), eval_step(state, inputs)
    same = torch.equal(got, trained)
    log(f"[{tag}] restored step {fresh.step} of {state.step}: log-probs "
        f"{'bit-equal' if same else 'differ'}, max |d| {(got - trained).abs().max().item():.3e}")
    if not same or fresh.step != state.step:
        raise AssertionError(f"[{tag}] the restored model is not the trained one")
    del state

    # cli.eval --checkpoint, its launches votes x batches x the path's forward.
    kernels.reset_launch_counts()
    res = cli_eval.main(data + ["--checkpoint", ckpt_dir, "--num_votes", str(RECIPE_VOTES),
                                "--num_repeat", str(RECIPE_REPEATS)])
    launches = dict(kernels.LAUNCHES)
    passes = len(res["pass_seconds"])
    log(f"[{tag}] cli.eval: " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()
                                          if isinstance(v, float))
        + f"; {passes} vote passes of {RECIPE_VOTES} votes x {res['clouds']} clouds; launches "
          f"{launches}")
    check_launches(f"{tag} eval", launches, spec["per_forward"], passes * RECIPE_VOTES * batches,
                   "forward")
    metrics = {k: v for k, v in res.items() if isinstance(v, float)}
    if not metrics or not all(0.0 <= v <= 1.0 for v in metrics.values()):
        raise AssertionError(f"[{tag}] eval metrics {res}")

    # The vote pool on the card against the CPU, the same weights and scales.
    n = spec["parity_batch"]
    card = tuple(t[:n] for t in inputs) if path == "partseg" else inputs[:n]
    cpu_state = cli_eval.eval_state(cfg, torch.device("cpu"))
    cpu_state.model.load_state_dict(fresh.model.state_dict())
    gen = torch.Generator().manual_seed(SEED)
    pts = (card[0] if path == "partseg" else card).cpu()
    scales = [draw_vote_scales(gen, pts) for _ in range(RECIPE_VOTES - 1)]

    def pool(state, x, device):
        if path == "partseg":
            onehot = x[1].to(device)
            fwd, x = (lambda p: eval_step(state, (p, onehot))), x[0]
        else:
            fwd = lambda p: eval_step(state, p)  # noqa: E731
        with torch.inference_mode():
            return vote_predict(fwd, x.to(device), RECIPE_VOTES,
                                scales=[s.to(device) for s in scales])[0].cpu()

    t1 = time.perf_counter()
    want_pool = pool(cpu_state, tuple(t.cpu() for t in card) if path == "partseg" else pts,
                     "cpu")
    cpu_s = time.perf_counter() - t1
    got_pool = pool(fresh, card, "cuda")
    if path == "partseg":
        agree = segmentation_agreement(got_pool, want_pool)
        ok = agree["median_abs"] <= SEG_LIMITS["median_abs"] and (
            agree["argmax_agreement"] >= SEG_LIMITS["argmax_agreement"])
        limits = SEG_LIMITS
    else:  # cls's served limit, which REPSURF_LIMITS holds
        agree = {"max_abs": (got_pool - want_pool).abs().max().item()}
        ok = agree["max_abs"] <= REPSURF_LIMITS["max_abs"]
        limits = REPSURF_LIMITS
    log(f"[{tag}] vote pool of {len(pts)} test clouds, card against the CPU ({cpu_s:.1f} s): "
        + ", ".join(f"{k} {v:.3e}" for k, v in agree.items()) + f" (limits {limits})")
    if not ok:
        raise AssertionError(f"[{tag}] the card's vote pool differs from the CPU's")

    clouds_s = RECIPE_VOTES * res["clouds"] / statistics.median(res["pass_seconds"])
    log(f"[{tag}] eval {clouds_s:.1f} clouds/s ({RECIPE_VOTES} votes x {res['clouds']} clouds "
        f"over the median of the pass seconds {res['pass_seconds']}); train step ms "
        f"{out['step_ms']}")
    return {"train": train_launches, "eval": launches, "clouds_s": clouds_s,
            "step_ms": out["step_ms"]}


# One-line faults for ``--planted-faults``: (path whose --parity readings
# the copy gives, file, text, replacement); "none" gives every path's.
PLANTED_FAULTS = {
    "none": None,
    "first claimant of every slot dropped": (
        "partseg", "mpa_tpu_torch/kernels/csrc/scatter_index.cuh",
        "for (int j = j0; j < j1; j += DEPTH) {",
        "for (int j = min(j0 + 1, j1); j < j1; j += DEPTH) {"),
    "count used without the clamp": (
        "partseg", "mpa_tpu_torch/kernels/csrc/scatter_index.cuh",
        "const float den = fmaxf(static_cast<float>(sh.claims[slot]), 1.f);",
        "const float den = static_cast<float>(sh.claims[slot]);"),
    "every fourth claim of a slot's list not added": (
        "partseg", "mpa_tpu_torch/kernels/csrc/scatter_index.cuh",
        "if (j + u < j1) add_row(acc, r[u]);",
        "if (j + u < j1 && u % 4 != 3) add_row(acc, r[u]);"),
    "backward without the divide by the count": (
        "partseg", "mpa_tpu_torch/ops/scatter.py",
        "g_norm = (grad / count.clamp_min(1.0)[..., None]).contiguous()",
        "g_norm = grad.contiguous()"),
    "windowed kNN: the last 16 rows of every window never searched": (
        "semseg", "mpa_tpu_torch/kernels/csrc/knn_search.cuh",
        "return {s0, min(s0 + qt, w.s_hi), w.win0, 2 * a.bn};",
        "return {s0, min(s0 + qt, w.s_hi), w.win0, 2 * a.bn - 16};"),
    "attention forward: the last neighbour's E left out of the denominator": (
        "semseg", "mpa_tpu_torch/kernels/csrc/attention_fwd.cuh",
        "if (k < K) denom = __fadd_rn(denom, e[k][i]);",
        "if (k < K - 1) denom = __fadd_rn(denom, e[k][i]);"),
    "attention backward: no tie split": (
        "semseg", "mpa_tpu_torch/kernels/csrc/attention_bwd.cuh",
        "const float dw = __fmul_rn(__fdiv_rn(1.f, cnt), gctx[orow + oc]);",
        "const float dw = gctx[orow + oc];"),
    "windowed scatter-mean: last chunk of the search skipped": (
        "semseg", "mpa_tpu_torch/kernels/csrc/window_scatter_mean.cu",
        "const int e_lo = lo * K, e_hi = hi * K;",
        "const int e_lo = lo * K, e_hi = max(hi - sq, lo) * K;"),
    "scatter-add: each cloud's last edge left out": (
        "repsurf", "mpa_tpu_torch/kernels/csrc/scatter_add.cu",
        "idx + e0, 0, E, 1,",
        "idx + e0, 0, E - 1, 1,"),
    "ball query: the last 32 base points never tested": (
        "repsurf", "mpa_tpu_torch/kernels/csrc/ball_query.cu",
        "const int n_slabs = min(32, (nt32 - c0) / 32);",
        "const int n_slabs = min(32, (nt32 - c0) / 32 - 1);"),
    "ball query: the radius compared where its square belongs": (
        "repsurf", "mpa_tpu_torch/kernels/csrc/ball_query.cu",
        "const unsigned m = __ballot_sync(FULL, d <= r2);",
        "const unsigned m = __ballot_sync(FULL, d <= sqrtf(r2));"),
    "gather: each cloud's last row left unwritten": (
        "partseg", "mpa_tpu_torch/kernels/csrc/gather.cu",
        "if (i < total) o[i] = v[k];",
        "if (i < total && (i / wv + 1) % E != 0) o[i] = v[k];"),
}


def window_replay_inputs() -> dict:
    """Recorded-call inputs of the four windowed kernels at an encoder pair
    of the semseg window_all path (8192 queries on 16384 points, Morton
    order, every fourth point repeated as in S3DIS blocks, so the attention
    meets tied neighbours), keyed by kernel name."""
    from mpa_tpu_torch.ops.morton import morton_sort
    from mpa_tpu_torch.ops.window import make_window_spec, windowed_knn_plain

    gen = torch.Generator().manual_seed(SEED)
    B, S, N, c = 2, 8192, 16384, 64
    xyz = torch.randn((B, N, 3), generator=gen)
    packed = torch.randn((B, N, 4 * c), generator=gen)
    packed[:, :, :c] = packed[:, :, :c].exp()
    packed[:, :, 2 * c:3 * c] = packed[:, :, 2 * c:3 * c].exp()
    xyz[:, 1::4], packed[:, 1::4] = xyz[:, 0::4], packed[:, 0::4]  # repeated points
    fine, perm = morton_sort(xyz)
    fine = fine.cuda()
    packed = torch.gather(packed, 1, perm.long()[..., None].expand(-1, -1, 4 * c)).cuda()
    coarse = fine[:, ::2].contiguous()
    spec = make_window_spec(S, N)
    _, idx = windowed_knn_plain(8, fine, coarse, spec)
    shifts = torch.randn((B, S, 2 * c), generator=gen).cuda()
    gctx = torch.randn((B, S, 2 * c), generator=gen).cuda()
    attn = {"packed": packed, "idx": idx, "shifts": shifts, "n_branches": 2, "c": c,
            "spec": spec}
    return {
        "windowed_knn_kernel": {"k": 8, "base": fine, "query": coarse, "spec": spec},
        "windowed_attention_fwd_kernel": attn,
        "windowed_attention_bwd_kernel": dict(attn, gctx=gctx),
        "windowed_scatter_mean_kernel": {"features": gctx, "knn_idx": idx, "num_fine": N,
                                         "spec": spec},
    }


def repsurf_parity(batch: int = PATHS["repsurf"]["parity_batch"]) -> dict:
    """``load_classifier("scanobjectnn_2x")`` on the card against the CPU
    (plain ops) from the same weights on ``batch`` ``surface_clouds``:
    ``segmentation_agreement`` of the log-probs (one row per cloud), and the
    inputs of the request's ``ball_query_kernel`` launches."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.data import surface_clouds
    from mpa_tpu_torch.serve import load_classifier

    spec = PATHS["repsurf"]
    x, _ = surface_clouds(batch, spec["points"], seed=SEED)
    kernels.recorded = []
    got = load_classifier(spec["preset"], seed=SEED)(x).cpu()
    recorded, kernels.recorded = kernels.recorded, None
    cpu = load_classifier(spec["preset"], seed=SEED, device="cpu")
    t0 = time.perf_counter()
    want = cpu(x)
    return dict(segmentation_agreement(got[None], want[None]), cpu_s=time.perf_counter() - t0,
                ball_query=[inp for name, inp in recorded if name == "ball_query_kernel"])


def parity_readings(path: str) -> dict:
    """``--parity PATH``: the path's card-against-CPU readings (``partseg``,
    ``semseg``, ``repsurf``, ``partseg_fp``, ``pose`` or ``completion``),
    replays of its newest kernels (for the last three: every launch of the
    served request) and of the card step's scatter-adds, each check's
    failure caught and reported."""
    from mpa_tpu_torch import kernels

    out = {}
    seg, limits = {"partseg": (segmenter_parity, SEG_LIMITS),
                   "semseg": (semseg_parity, SEMSEG_LIMITS),
                   "repsurf": (repsurf_parity, REPSURF_LIMITS),
                   "partseg_fp": (lambda: segmenter_parity(preset="shapenetpart_fp"), SEG_LIMITS),
                   "pose": (lambda: cloud_parity("pose"), CLOUD_LIMITS),
                   "completion": (lambda: cloud_parity("completion"), CLOUD_LIMITS)}[path]
    seg = seg()
    out["served"] = {k: seg[k] for k in ("median_abs", "p99_abs", "max_abs", "argmax_agreement")}
    out["served_within_limits"] = within(seg, limits)
    kernels.recorded = []
    parity = train_parity(path)
    recorded, kernels.recorded = kernels.recorded, None
    out["train"] = {"loss_diff": parity["loss_diff"], "grad_units": parity["grad_units"][:3],
                    "stat": parity["stat"]}
    scatter_adds = [inp for name, inp in recorded if name == "scatter_add_rows_kernel"]
    if path in ("partseg_fp", "pose", "completion"):
        checks = [(f"{len(seg['recorded'])} replays of the request", lambda: [
            check_call(name, inp) for name, inp in seg["recorded"]])]
    elif path == "repsurf":
        checks = [(f"ball query replay {i}", lambda inp=inp: check_call("ball_query_kernel", inp))
                  for i, inp in enumerate(seg["ball_query"])]
    elif path == "partseg":
        gen = torch.Generator().manual_seed(SEED)
        inp = {"features": torch.randn((4, 1024, 64), generator=gen).cuda(),
               "knn_idx": torch.randint(0, 2048, (4, 1024, 8), generator=gen,
                                        dtype=torch.int32).cuda(),
               "num_fine": 2048}
        checks = [("replay", lambda: check_call("scatter_mean_kernel", inp)),
                  ("backward", lambda: check_scatter_mean_grad(inp)),
                  (f"{len(seg['gather'])} gather replays of the request", lambda: [
                      check_call("gather_rows_kernel", g) for g in seg["gather"]])]
    else:
        inputs = window_replay_inputs()
        checks = [(name, lambda name=name, inp=inp: check_call(name, inp))
                  for name, inp in inputs.items()]
        checks.append(("windowed scatter-mean backward", lambda: check_scatter_mean_grad(
            inputs["windowed_scatter_mean_kernel"])))
    checks.append((f"{len(scatter_adds)} scatter-add replays of the train step", lambda: [
        check_call("scatter_add_rows_kernel", inp) for inp in scatter_adds]))
    for what, check in checks:
        try:
            check()
            out[what] = "passes"
        except AssertionError as e:
            out[what] = "fails: " + str(e).splitlines()[0][:120]
    return out


def planted_faults(only: str = "all") -> None:
    """``--planted-faults [PATH]``: for each entry of ``PLANTED_FAULTS`` (of
    path ``only``, or all), a copy of the port in a temporary directory with
    that one line changed runs ``chip_smoke.py --parity`` for the fault's
    path (the copy without a fault for each such path); prints each copy's
    readings. The limits of ``SEG_LIMITS``, ``SEMSEG_LIMITS``,
    ``REPSURF_LIMITS`` and ``grad_limit`` lie between a correct copy's
    readings and the faulty ones'."""
    parity_paths = ["partseg", "semseg", "repsurf"]
    if only != "all":
        parity_paths = [only]
    with tempfile.TemporaryDirectory() as tmp:
        for name, fault in PLANTED_FAULTS.items():
            if fault is not None and fault[0] not in parity_paths:
                continue
            root = Path(tmp) / re.sub(r"\W+", "_", name)
            shutil.copytree(REPO / "mpa_tpu_torch", root / "mpa_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
            paths = parity_paths
            if fault is not None:
                path, file, old, new = fault
                paths = [path]
                text = (root / file).read_text()
                if text.count(old) != 1:
                    raise AssertionError(f"fault {name!r}: {old!r} not found once in {file}")
                (root / file).write_text(text.replace(old, new))
            for path in paths:
                proc = subprocess.run([sys.executable, "chip_smoke.py", "--parity", path],
                                      cwd=root, capture_output=True, text=True, timeout=900)
                last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
                log(f"[planted] {name} ({path}): exit {proc.returncode} "
                    f"{last or proc.stderr[-400:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parity", nargs="?", const="partseg",
                    choices=["partseg", "semseg", "repsurf", "partseg_fp", "pose", "completion"],
                    help="only that path's card-against-CPU readings, as JSON")
    ap.add_argument("--planted-faults", nargs="?", const="all",
                    choices=["all", "partseg", "semseg", "repsurf"],
                    help="the --parity readings of copies with one fault planted in each "
                         "(of that path's faults only, if given)")
    args = ap.parse_args()
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

    if args.planted_faults:
        log(f"[planted] {card_line()}")
        planted_faults(args.planted_faults)
        return 0
    if args.parity:
        print(json.dumps(parity_readings(args.parity)), flush=True)
        return 0

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

    # -- 2, 2b, 3: markov_cls served and trained, its launches replayed ----------
    served = {"cls": serve_phase("cls", "2 cls served")}
    trained = {"cls": train_phase("cls", "2b cls trained")}
    rows = replay("cls", served["cls"], trained["cls"])
    del served["cls"]["recorded"], trained["cls"]["recorded"]
    torch.cuda.empty_cache()

    # -- 2c, 2d, 3: markov_partseg served and trained, its launches replayed -----
    served["partseg"] = serve_phase("partseg", "2c partseg served")
    trained["partseg"] = train_phase("partseg", "2d partseg trained")
    rows += replay("partseg", served["partseg"], trained["partseg"])
    del served["partseg"]["recorded"], trained["partseg"]["recorded"]
    torch.cuda.empty_cache()

    # -- 2e, 2f, 3: markov_semseg window_all served and trained, replayed -------
    served["semseg"] = serve_phase("semseg", "2e semseg served")
    trained["semseg"] = train_phase("semseg", "2f semseg trained")
    rows += replay("semseg", served["semseg"], trained["semseg"])
    del served["semseg"]["recorded"], trained["semseg"]["recorded"]
    torch.cuda.empty_cache()

    # -- 2g, 2h, 3: repsurf_ssg_2x served and trained, replayed; FPS at 16384 ---
    served["repsurf"] = serve_phase("repsurf", "2g repsurf served")
    trained["repsurf"] = train_phase("repsurf", "2h repsurf trained")
    rows += replay("repsurf", served["repsurf"], trained["repsurf"])
    del served["repsurf"]["recorded"], trained["repsurf"]["recorded"]
    torch.cuda.empty_cache()
    rows += fps_16384_phase()

    # -- 2i-2n, 3: markov_partseg_fp, markov_pose, markov_completion ------------
    for path, (s_tag, t_tag) in {"partseg_fp": ("2i", "2j"), "pose": ("2k", "2l"),
                                 "completion": ("2m", "2n")}.items():
        served[path] = serve_phase(path, f"{s_tag} {path} served")
        trained[path] = train_phase(path, f"{t_tag} {path} trained")
        rows += replay(path, served[path], trained[path])
        del served[path]["recorded"], trained[path]["recorded"]
        torch.cuda.empty_cache()

    # -- 2o, 3: markov_partseg served in the window modes --------------------------
    windowed = {mode: partseg_window_phase(mode, f"2o partseg {mode} served")
                for mode in PARTSEG_WINDOW_FORWARD}
    for mode, w in windowed.items():
        rows += w.pop("rows")
    torch.cuda.empty_cache()

    floor = launch_floor()
    log(f"[3 floor] empty_kernel (one block of one thread) in the same CUDA-graph harness: "
        f"{floor:.4f} ms a launch")

    # -- 5: the recipe, cli.train -> checkpoint -> cli.eval, on data trees -------
    with tempfile.TemporaryDirectory() as work:
        recipe = {path: recipe_phase(path, f"5 {path} recipe", Path(work)) for path in RECIPE}
    torch.cuda.empty_cache()

    # -- 6: S3DIS rooms through cli.train and the sliding scene inference ------------
    with tempfile.TemporaryDirectory() as work:
        scene = s3dis_phase("6 s3dis", Path(work))
    rows += scene.pop("rows")
    torch.cuda.empty_cache()

    counts = {f"{path}_serve": served[path]["launches"] for path in PATHS}
    counts.update({f"{path}_train": trained[path]["launches"] for path in PATHS})
    counts.update({f"{path}_recipe_{run}": recipe[path][run] for path in RECIPE
                   for run in ("train", "eval")})
    counts.update({f"partseg_{mode}_serve": w["launches"] for mode, w in windowed.items()})
    counts.update({f"s3dis_{run}": scene[run] for run in ("train", "scene")})
    summary = [summarise(name, rows, counts) for name in kernels.KERNELS]
    log("[4 kernels] times are per request for the forward kernels and per train step for "
        "the backward kernels: the sum over its launches of each; top level: the kernel's "
        "path, markov_semseg window_all at B=2 x 16384 points for the windowed kernels, "
        "repsurf_ssg_2x at B=64 x 1024 points for the ball query, markov_partseg at "
        "B=32 x 2048 points for the others; by_path.cls and by_path.repsurf: markov_cls and "
        "repsurf_ssg_2x at B=64 x 1024 points")
    for path, spec in PATHS.items():
        lat, step = served[path]["latency_ms"], trained[path]["step_ms"]
        log(f"[4 {path}] ({card}) request ms {lat}, median {statistics.median(lat):.3f} ms, "
            f"{spec['batch'] / statistics.median(lat) * 1e3:.1f} clouds/s")
        log(f"[4 {path}] ({card}) train step ms {step}, median {statistics.median(step):.3f} ms, "
            f"{spec['batch'] / statistics.median(step) * 1e3:.1f} clouds/s")
    for mode, w in windowed.items():
        lat = w["latency_ms"]
        log(f"[4 partseg_{mode}] ({card}) request ms {lat}, median "
            f"{statistics.median(lat):.3f} ms, "
            f"{PATHS['partseg']['batch'] / statistics.median(lat) * 1e3:.1f} clouds/s")
    log(f"[6 s3dis] ({card}) cli.train step ms {scene['step_ms']}, median "
        f"{statistics.median(scene['step_ms']):.3f} ms; scene inference {scene['scene_s']:.3f} s "
        f"for {scene['scene_points']} points ({scene['scene_host_s']:.3f} s of it host work); "
        f"card vs cpu label agreement "
        f"{scene['label_agreement']:.5f}")
    for path, r in recipe.items():
        log(f"[5 {path}] recipe ({card}): eval {r['clouds_s']:.1f} clouds/s, train step ms "
            f"{r['step_ms']}, median {statistics.median(r['step_ms']):.3f} ms")
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
