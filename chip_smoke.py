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
6), and DGCNN (``--model dgcnn``) served, trained and exported with the
extras' other kernel users (phase 10). It shows that they run through the
port's twelve hand-written kernels (nine forward, three backward) and, in
train mode, the fused BatchNorm + LeakyReLU pair (phase 3b):

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
7. data parallelism and the trainer's surface (run after phase 6): (a) two
   spawned ranks on the one card (``gloo``: NCCL refuses two ranks on one
   device), each with half of a ``scanobjectnn_cls`` batch of 64 x 1024,
   against one process on the whole batch with the plain ops on the CPU,
   two steps (SGD at the preset's rate, dropout 0) from the same weights:
   the first step's loss within 1e-4, its averaged gradients within the
   path's ``grad_limit`` units and its BatchNorm running means and biased
   variances within 1e-4 relative; after the second, the parameters, the
   running statistics and the loss within ``DP_LIMITS`` of the reference's
   own motion from the initial weights (and from step 1's loss); the ranks
   bit-equal, each rank's launches exactly two cls train steps'; (b) ``cli.train --init xavier`` three steps under a one-rank
   NCCL group joined from torchrun's environment, its launches exactly the
   steps' and its eval's, its first step's launches replayed as in phase 3
   (tagged ``ddp``); (c) a reference-layout ``best_model.pth``
   (``reference_checkpoint``) through ``cli.train --import_torch`` (lr 0:
   the parameters stay the imported ones, bit for bit) and ``cli.eval
   --import_torch``, the imported model's served log-probs on the card
   against the CPU's within ``CLOUD_LIMITS`` and against the CPU in float64
   within ``IMPORT_F64_LIMIT``; (d) one train step each of cls
   (its encoder's ``fps_random_start`` set), part-seg and part-seg in ``window_all`` with keyed
   FPS starts drawn on the card, every ``fps_kernel`` launch replayed with
   its starts (tagged ``keyed_*``);
8. mixed precision (run after phase 7): ``markov_cls`` and ``markov_partseg``
   with ``compute_dtype=torch.bfloat16`` at the widths of phases 2 and 2c,
   and ``markov_partseg`` in ``window`` and ``window_all`` at 2c's
   (``partseg_window``, ``partseg_window_all``; ``WINDOW_PATHS``):
   (a) served through ``load_classifier`` / ``load_segmenter(compute_dtype=
   ..., neighbor_mode=...)``, two warm-up and three timed requests, the launch counts exactly
   the float32 paths' in all and ``BF16_PATHS``' in bf16, float32 log-probs
   whose rows sum to 1, the card against the CPU's bf16 model (plain ops)
   on ``parity_batch`` clouds within ``BF16_LIMITS``, and beside it the
   card's float32 model against its bf16 one and the bf16 model with
   cuBLAS's reduced-precision bf16 reduction let on; (b) the preset's train
   step of the bf16 model, two warm-up and five timed steps with exact
   counts and the peak memory, parameters and gradients float32, and one
   step at ``parity_batch`` against the CPU's within ``BF16_TRAIN_LIMITS``'
   loss and ``grad_limit`` units; (c) every bf16 launch of a request and of a
   step's backward replayed against its plain version (tagged
   ``PATH_bf16``), as phase 3's float32 launches, with one bf16 ulp more
   where those have a tolerance, and the scatter-means' backward at every
   recorded launch; (d) the request and step medians of bf16 beside
   float32 (for the window modes phase 2o's requests and five float32
   steps taken here, their launches exact) and each bf16 kernel's time;
9. inference export (run after phase 8): ``markov_cls``
   (``scanobjectnn_cls``, B = 64 x 1024), ``markov_partseg`` (``shapenetpart``,
   B = 32 x 2048) exact and in ``window_all``, ``repsurf_ssg_2x`` (B = 64 x
   1024) and the bf16 ``markov_cls``, each the serving loader's model,
   exported on the card through the kernels' custom ops
   (``serve.export_inference``) and saved, its export seconds, graph nodes
   and artifact bytes logged; ``python -m mpa_tpu_torch.cli.export`` on
   phase 5's ``modelnet40_cls`` checkpoint (B = 64); every program answers
   two warm-up and ten timed requests eagerly (the cli's: the model restored
   from the checkpoint), then one child process, which imports
   ``mpa_tpu_torch.ops`` and no model code (it asserts so), loads every
   artifact with ``serve.load_inference`` and answers the same requests:
   the answers bit-equal to the eager ones, each request's launches of each
   kernel (and of bf16 storage) exactly the eager request's, the nine
   forward kernels launched among the programs, and the request medians of
   both logged;
10. DGCNN and the extras (run after phase 9): (a) ``load_classifier(model=
   "dgcnn")`` (``scanobjectnn_cls``, k = 20, EdgeConv widths 64/64/128/256,
   B = 64 x 1024) answers two warm-up and three timed requests, its
   launches exactly 4 ``knn_kernel`` and 4 ``gather_rows_kernel`` a
   request, finite logits, the request median and the device's busy share
   (``busy_share``, under ``torch.profiler``), the logits of 4 clouds on the
   card against the CPU within ``DGCNN_LIMITS``, and every launch of one
   more request replayed as in phase 3 (with the kNN distance gradient);
   (b) the preset's train step of the DGCNN, five timed with their
   launches (3 scatter-adds a step: the first block's gather is of the
   points, which carry no gradient) and busy share, ten steps on one batch
   lowering the loss (read on logits, as ``mpa_tpu`` trains it), one step
   at B = 4 against the CPU within ``DGCNN_PATH``'s own limits, and the
   step's scatter-adds and gathers replayed; (c) ``cli.train --model
   dgcnn`` three steps with its eval, ``cli.eval`` of its checkpoint (their
   launches exact) and ``cli.export`` of it, the artifact loaded in phase
   9's child process (no model code) and answering bit-equal to the
   restored eager model with the same launches; (d) ``Disp3DEncoder`` at its
   defaults, ``knn_surface_features``, ``inner_correlation(index=)`` and
   the k = 5 umbrella of a train-mode ``MarkovClassifier(use_umbrella=True,
   umbrella_k=5)`` on 8 x 1024 clouds against the CPU
   (``OFFPATH_REL_LIMIT``), every launch replayed. Its readings print as
   ``[10 ...]`` lines before the card line; the kernels line is phases
   1-9's;
3b. the fused train-mode BatchNorm + LeakyReLU (``ops/batch_norm.py``,
   run after the launch floor, or alone with ``--batch-norm``): forward and
   backward against the plain version on the card at the rows of the main
   paths' widest norms and at shapes that reach the kernels' other forms,
   within ``BATCH_NORM_LIMITS``, each row's time beside its bound and the
   plain version's time;
4. a ``{"kernels": [...]}`` JSON line (the bf16 launches as entries of
   their own, ``NAME[bf16]``), then the last line
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


# Phase 8's markov_partseg in the window modes, ``partseg_window`` and
# ``partseg_window_all``: the part-seg path's batch, widths and parity
# batch. A train step adds what part-seg's adds: the backward of every
# attention call (windowed or exact) and of every gather whose source
# carries a gradient, and the scatter-means' backward gathers.
WINDOW_PATHS = {
    f"partseg_{mode}": dict(
        PATHS["partseg"], overrides=dict(neighbor_mode=mode), per_forward=fwd,
        per_train_step=dict(
            fwd, gather_rows_kernel=18 + 14, scatter_add_rows_kernel=14,
            windowed_attention_bwd_kernel=fwd["windowed_attention_fwd_kernel"],
            **({"transition_attention_bwd_kernel": fwd["transition_attention_fwd_kernel"]}
               if "transition_attention_fwd_kernel" in fwd else {})))
    for mode, fwd in PARTSEG_WINDOW_FORWARD.items()}


# Phase 10's DGCNN: ``scanobjectnn_cls`` with ``--model dgcnn`` at its published
# widths (k = 20, EdgeConv widths 64/64/128/256), B = 64 clouds of 1024 points.
# Each EdgeConv block searches its input's feature space (C = 3, 64, 64, 128)
# and gathers the k neighbours' rows; a train step scatter-adds their
# gradients back, but for the first block's gather of the points, which
# carry none. Its card-against-CPU checks at B = 4.
DGCNN_FORWARD = {"knn_kernel": 4, "gather_rows_kernel": 4}
DGCNN_PATH = dict(
    preset="scanobjectnn_cls", batch=64, points=1024, parity_batch=4,
    overrides=dict(model="dgcnn"), cli=["--model", "dgcnn"],
    per_forward=DGCNN_FORWARD,
    per_train_step=dict(DGCNN_FORWARD, scatter_add_rows_kernel=3),
    # Its step against the CPU's is read against these limits, not PATHS'
    # (correct copy / planted kNN fault, measured on one NVIDIA H100 80GB HBM3,
    # 700.00 W): gradient units 65.5 / 1433, loss |d| 9.4e-05 / 5.6e-02, the
    # worst statistic 1.2e-03 / 7.3e-02. Each EdgeConv's max over 20
    # neighbours and the heads' train-mode BatchNorm over 4 clouds amplify
    # float32 rounding, and the logits enter the loss unsquashed.
    grad_limit=300, loss_limit=1e-3, stat_limit=1e-2,
)
# The served DGCNN logits on the card against the CPU's, at B = 4: the largest
# difference of a logit (correct copy 4.9e-06, the planted kNN fault 5.3e-02,
# measured on one H100). The argmax agreement is reported, not limited.
DGCNN_LIMITS = {"max_abs": 1e-3}
# Phase 10d's off-path kernel users on the card against the CPU, the largest
# difference of an output entry over the largest entry: float32 products in
# another order (cuBLAS against the CPU), every kNN on coordinates (exact on
# both sides) or its indices handed over.
OFFPATH_REL_LIMIT = 1e-4


# Phase 3b's rows ``(R, C, act)``: part-seg's full-resolution units at 256 x
# 2048 points (C = 64, and 512 in its head) and DGCNN's last EdgeConv block at
# 64 x 1024 x 20 edges (C = 256), the shapes the benchmark's train cells run;
# then shapes that reach the reduction's other shapes (``reduce_config``): one
# row, and seven, where each row group takes channels of its own; two and one
# channels a thread; one block a column; many blocks a column at C = 1024.
BATCH_NORM_ROWS = [(524288, 64, True), (524288, 512, True), (1310720, 256, True),
                   (524288, 64, False)]
BATCH_NORM_FORMS = [(1, 64, True), (7, 3, True), (1000, 10, False), (4096, 1030, True),
                    (3, 2052, True), (65536, 1024, True), (64, 512, True)]
# The kernels against the plain version on the card, each the largest
# difference over the largest magnitude: the forward's output and running
# statistics against ``batch_norm_act_plain``, the backward's against autograd
# through it. The kernels take every sum in the order of PyTorch's own
# reduction and round every step as the plain version's operations do, so
# they agree bit for bit: each limit is 0.
BATCH_NORM_LIMITS = {"y": 0.0, "running": 0.0, "dx": 0.0, "dweight": 0.0, "dbias": 0.0}


def batch_norm_row(R: int, C: int, act: bool, timed: bool) -> dict:
    """One phase 3b row: the fused forward and backward on ``[R, C]`` rows
    against the plain version, and with ``timed`` their times (``time_graph``)
    beside the bound (the bytes of the input read once and the output written
    once at 3.35 TB/s: forward x in and y out, backward dy and x in and dx
    out) and the plain version's (``time_events``; its backward is
    autograd's)."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.ops import batch_norm as bn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(R * 7 + C)
    x = torch.randn((R, C), generator=g, device=dev) * 3.0 + 0.5
    w = torch.rand((C,), generator=g, device=dev) + 0.5
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    dy = torch.randn((R, C), generator=g, device=dev)
    rm, rv = torch.randn((C,), generator=g, device=dev), torch.rand((C,), generator=g, device=dev)
    stats_k, stats_p = (rm.clone(), rv.clone()), (rm.clone(), rv.clone())
    before = dict(kernels.NORM_LAUNCHES)
    y, mean, rstd = bn.batch_norm_act_op(x, w, b, *stats_k, 1e-5, 0.1, act)
    dx, dw, db = bn.batch_norm_act_bwd_op(dy, x, w, b, mean, rstd, act)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = bn.batch_norm_act_plain(*leaves, *stats_p, 1e-5, 0.1, act)
    wdx, wdw, wdb = torch.autograd.grad(want, leaves, dy)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in kernels.NORM_LAUNCHES.items()} == {
        "batch_norm_act_kernel": 1, "batch_norm_act_bwd_kernel": 1}

    def gap(got, ref):
        return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    row = {"R": R, "C": C, "act": act, "reduction": bn.reduce_config(R, C), "gaps": {
        "y": gap(y, want.detach()),
        "running": max(gap(k, p) for k, p in zip(stats_k, stats_p)),
        "dx": gap(dx, wdx), "dweight": gap(dw, wdw), "dbias": gap(db, wdb)}}
    bad = {k: v for k, v in row["gaps"].items() if not v <= BATCH_NORM_LIMITS[k]}
    assert not bad, f"batch_norm_act [{R}, {C}] act={act}: {bad} over {BATCH_NORM_LIMITS}"
    if timed:
        def plain_bwd():
            out = bn.batch_norm_act_plain(*leaves, *stats_p, 1e-5, 0.1, act)
            torch.autograd.grad(out, leaves, dy)

        row.update(
            ms=time_graph(lambda: bn.batch_norm_act_op(x, w, b, *stats_k, 1e-5, 0.1, act)),
            bwd_ms=time_graph(lambda: bn.batch_norm_act_bwd_op(dy, x, w, b, mean, rstd, act)),
            bound_ms=8 * R * C / PEAK_BYTES_PER_S * 1e3,
            bwd_bound_ms=12 * R * C / PEAK_BYTES_PER_S * 1e3,
            plain_ms=time_events(lambda: bn.batch_norm_act_plain(x, w, b, *stats_p, 1e-5, 0.1,
                                                                 act)),
            plain_fwd_bwd_ms=time_events(plain_bwd))
    return row


def batch_norm_phase(tag: str) -> list:
    """Phase 3b: ``BATCH_NORM_ROWS`` checked and timed, ``BATCH_NORM_FORMS``
    checked; one log line a row."""
    card = card_line()
    rows = []
    for R, C, act in BATCH_NORM_ROWS + BATCH_NORM_FORMS:
        row = batch_norm_row(R, C, act, timed=(R, C, act) in BATCH_NORM_ROWS)
        rows.append(row)
        gaps = ", ".join(f"{k} {v:.2e}" for k, v in row["gaps"].items())
        line = f"[{tag}] [{R}, {C}] act={act} reduction {row['reduction']}: {gaps}"
        if "ms" in row:
            line += (f"; ({card}) forward {row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, "
                     f"plain {row['plain_ms']:.4f}), backward {row['bwd_ms']:.4f} ms (bound "
                     f"{row['bwd_bound_ms']:.4f}); plain forward + autograd backward "
                     f"{row['plain_fwd_bwd_ms']:.4f} ms")
        log(line)
        torch.cuda.empty_cache()
    return rows


def path_spec(path: str) -> dict:
    """The entry of ``PATHS`` or ``WINDOW_PATHS`` for ``path``, or
    ``S3DIS_PATH`` for ``"s3dis"``, ``DGCNN_PATH`` for ``"dgcnn"``."""
    if path == "s3dis":
        return S3DIS_PATH
    if path == "dgcnn":
        return DGCNN_PATH
    return WINDOW_PATHS[path] if path in WINDOW_PATHS else PATHS[path]


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
# Phase 7c: the imported model's served log-probs on the card against the
# CPU in float64 (read 7.549e-07, where the CPU in float32 reads 5.039e-04).
IMPORT_F64_LIMIT = 1e-5
# Gradients that are zero up to rounding in these models: the k projections'
# biases (a shift of k cancels in the attention's normalisation), the q
# projections (no part in the output), and the biases of the Dense layers
# ahead of a train-mode BatchNorm (in repsurf also the umbrella's last one,
# whose shift every consumer of the normals passes to a train-mode
# BatchNorm, and the last BatchNorm bias of the group-all stage: its max over
# 32 centres is positive in every cloud, so the shift passes through the max
# to the head's train-mode BatchNorm; in markov_partseg_fp likewise the
# BatchNorm bias of conv6, whose max over each cloud's points is broadcast
# to every point of head1's train-mode BatchNorm; in DGCNN the bias of
# linear2, ahead of bn7). Only these get an absolute floor.
ROUNDING_ZERO = re.compile(
    r"(\.k\.bias|\.q\.(weight|bias)|\.linear\.bias|^fc[12]\.bias|^linear2\.bias"
    r"|\.final_class\.bias"
    r"|\.mlp_[lf]0\.bias|\.conv\d+\.bias|surface_constructor\.mlp[12]\.bias"
    r"|^sa4\.mlps\.bn1\.bias|^conv6\.norm\.bias)$")
# In bf16 steps, also the value projections' biases (a shift of v passes
# through the max over the neighbours into a train-mode BatchNorm: their
# gradients are at most 9e-4 of the whole gradient's norm in float64 on the
# CPU, below bf16's resolution of it), and for all of these a floor of that
# resolution, 2^-8 of the whole gradient's norm.
BF16_ROUNDING_ZERO = re.compile(ROUNDING_ZERO.pattern + r"|\.v\.bias$")
BF16_ZERO_FLOOR = 2.0 ** -8
# The TPU kernel each port kernel replaces (its source: ``kernels.SOURCES``).
REPLACES = {
    "knn_kernel": "mpa_tpu/ops/pallas/knn_pallas.py:102",
    "fps_kernel": "mpa_tpu/ops/pallas/fps_pallas.py:70",
    "gather_rows_kernel": "mpa_tpu/ops/pallas/gather_pallas.py:97",
    "transition_attention_fwd_kernel": "mpa_tpu/ops/pallas/attention_pallas.py:452",
    "scatter_add_rows_kernel": "mpa_tpu/ops/pallas/gather_pallas.py:267",
    "transition_attention_bwd_kernel": "mpa_tpu/ops/pallas/attention_pallas.py:388",
    "scatter_mean_kernel": "mpa_tpu/ops/pallas/scatter_pallas.py:70",
    "windowed_knn_kernel": "mpa_tpu/ops/pallas/window_attention.py:153",
    "windowed_attention_fwd_kernel": "mpa_tpu/ops/pallas/window_attention.py:399",
    "windowed_attention_bwd_kernel": "mpa_tpu/ops/pallas/window_attention.py:431",
    "windowed_scatter_mean_kernel": "mpa_tpu/ops/pallas/window_attention.py:577",
    "ball_query_kernel": "mpa_tpu/ops/pallas/ball_pallas.py:72",
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
    once and each output written once, each at its own element size (2
    bytes for bf16); operations counted from the shapes (float32 arithmetic
    in bf16 storage too)."""
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
        # The rows the index names, each read once (this call's index: DGCNN's
        # names each row 20 times), and the output written once.
        s = torch.sort(inp["idx"], dim=1).values
        named = B * min(E, 1) + int((s[:, 1:] != s[:, :-1]).sum())
        nbytes = inp["points"].element_size() * (named + B * E) * W + 4 * B * E
        ops = 0
    elif name == "scatter_add_rows_kernel":
        B, E, W = inp["grads"].shape
        es = inp["grads"].element_size()  # the output has the gradient's type
        nbytes = es * (B * E * W + B * inp["num_points"] * W) + 4 * B * E
        ops = B * E * W  # one add per gradient value
    elif name in ("scatter_mean_kernel", "windowed_scatter_mean_kernel"):
        B, S, C = inp["features"].shape
        K, N = inp["knn_idx"].shape[2], inp["num_fine"]
        es = inp["features"].element_size()  # the mean has the features' type, the count is f32
        nbytes = es * (B * S * C + B * N * C) + 4 * (B * S * K + B * N)
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
        # written once, in packed's type.
        es = inp["packed"].element_size()
        nbytes = es * (2 * B * N * Win + B * S * Wo * (1 + 2 * sh)) + 4 * B * S * K
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
        es = inp["packed"].element_size()  # packed, shifts and the context share it
        nbytes = es * (B * N * Win + B * S * Wo * (2 if has_shift else 1)) + 4 * B * S * K
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
                    generator=torch.Generator(device=feats.device).manual_seed(SEED)).to(feats.dtype)
    kern = scatter_mean_upsample
    if "spec" in inp:
        kern = lambda f, i, m: windowed_scatter_mean(f, i, m, inp["spec"])  # noqa: E731
    grads = []
    for fn in (kern, lambda f, i, m: scatter_mean_plain(f, i, m)[0]):
        f = feats.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(f, idx, n), f, g)[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(grads[0].float(), grads[1].float(), rtol=bf16_rtol(1e-5, grads[0]),
                               atol=1e-6)
    return (grads[0].float() - grads[1].float()).abs().max().item()


def bf16_rtol(rtol: float, t: torch.Tensor) -> float:
    """``rtol`` of a float32 comparison, and for a bf16 ``t`` one bf16 ulp
    more (2^-7 of the magnitude): a float32 sum that differs in its last
    bits can round to the neighbouring bf16."""
    return rtol + (2.0 ** -7 if t.dtype == torch.bfloat16 else 0.0)


def check_call(name: str, inp: dict) -> dict:
    """Kernel against plain version on one recorded call, with its times.
    bf16 launches are held as the float32 ones, bit for bit where those are,
    and within one bf16 ulp more where those have a tolerance."""
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
        shape = ("{} points {} idx {}, {} values a column, {} columns a thread"
                 .format(pts.dtype, tuple(pts.shape), tuple(idx.shape),
                         *gather_form(pts, idx.numel())))
    elif name == "scatter_add_rows_kernel":
        grads, idx, n = inp["grads"], inp["idx"], inp["num_points"]
        B, _, W = grads.shape
        kern, plain = (lambda: scatter_add_cuda(grads, idx, n)), (lambda: scatter_add_plain(grads, idx, n))
        rows = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n).reshape(-1)
        flat_grads = grads.reshape(-1, W)
        library = lambda: torch.zeros((B * n, W), dtype=grads.dtype,  # noqa: E731
                                      device=grads.device).index_add_(0, rows, flat_grads)
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
        err = assert_close_scaled(got.float(), want.float(), rtol=bf16_rtol(1e-5, got), what=name)
        ref = want.abs().max().item()
        shape = ("{} grads {} into N={}, {} slots a block, {} channels a lane"
                 .format(grads.dtype, tuple(grads.shape), n, *scatter_add_form(grads, n)))
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
            total = torch.zeros((B * n, C), dtype=feats.dtype,
                                device=feats.device).index_add_(0, rows, vals)
            cnt = torch.zeros((B * n,), device=feats.device).index_add_(0, rows, ones)
            return (total / cnt.clamp_min(1.0)[:, None]).to(feats.dtype)

        rows_c = rows[:, None].expand(-1, C)
        library = lambda: torch.zeros((B * n, C), dtype=feats.dtype,  # noqa: E731
                                      device=feats.device).scatter_reduce_(
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
        torch.testing.assert_close(got.float(), want.float(), rtol=bf16_rtol(1e-5, got), atol=1e-5)
        err = (got.float() - want.float()).abs().max().item()
        shape = f"{feats.dtype} features {tuple(feats.shape)} idx {tuple(idx.shape)} into N={n}"
        form = scatter_mean_form(feats, n) if spec is None else windowed_scatter_mean_form(feats, n)
        shape += ", {} slots a block, {} channels a lane".format(*form)
        extra["index_add_ms"] = time_graph(index_adds)
    elif name in ("transition_attention_bwd_kernel", "windowed_attention_bwd_kernel"):
        args = (inp["packed"], inp["idx"], inp["shifts"], inp["gctx"], inp["n_branches"], inp["c"])
        kern, plain = (lambda: attention_bwd_cuda(*args)), (lambda: attention_bwd_plain(*args))
        if spec is not None:
            kern = lambda: windowed_attention_bwd_cuda(*args, spec)  # noqa: E731
        (gp, gs), (wp, ws) = kern(), plain()
        if gp.dtype != args[0].dtype or (gs is not None and gs.dtype != args[0].dtype):
            raise AssertionError(f"{name}: gradients of type {gp.dtype}, want {args[0].dtype}")
        err = assert_close_scaled(gp.float(), wp.float(), rtol=bf16_rtol(1e-4, gp),
                                  what=f"{name} dpacked")
        if args[2] is not None:
            err = max(err, assert_close_scaled(gs.float(), ws.float(), rtol=bf16_rtol(1e-5, gs),
                                               what=f"{name} dshift"))
        ref = wp.abs().max().item()
        shape = (f"{args[0].dtype} packed {tuple(args[0].shape)} idx {tuple(args[1].shape)} "
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
        shape = (f"{args[0].dtype} packed {tuple(args[0].shape)} idx {tuple(args[1].shape)} "
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


def grad_error_units(got: dict, want: dict, zero: re.Pattern = ROUNDING_ZERO,
                     zero_floor: float = 1e-5) -> list:
    """Per parameter, the L2 distance of ``got``'s gradient from ``want``'s in
    units of 1e-3 of ``want``'s norm; for the tensors ``zero`` names (zero up
    to rounding) the unit adds ``zero_floor`` of the whole gradient's norm.
    Largest first, as ``(name, units)``."""
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want.values())))
    units = {}
    for name, w in want.items():
        unit = 1e-3 * float(w.norm()) + (zero_floor * total if zero.search(name) else 0.0)
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


def train_parity(path: str, **model_kw) -> dict:
    """One step of the path's preset with dropout 0 on the card and on the
    CPU (plain ops), from the same weights, with the same umbrella flips
    (``fix_flips``), on the first ``parity_batch`` training clouds. Returns
    the loss difference, ``grad_error_units`` of the gradients, the worst
    error of a BatchNorm running statistic (relative to its norm plus 1e-3
    an entry) as ``(name, value)``, the card step's launch counts (and its
    bf16 ones) and both steps' wall seconds. ``model_kw`` reach the model's
    constructor; with ``compute_dtype`` the gradient units take
    ``BF16_ROUNDING_ZERO`` and its floor."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import create_train_state

    spec, cfg = path_spec(path), path_config(path, parity=True)
    arrays = train_arrays(path, cfg)
    head = tuple(a[:spec["parity_batch"]] for a in arrays)
    if path != "completion":
        model_kw = dict(model_kw, dropout=0.0)
    model = fresh_model(path, cfg, **model_kw)
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
        results[device.type] = (loss, grads, stats, wall,
                                (dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BF16)))
    (lg, gg, sg, wg, (launches, bf16)), (lc, gc, sc, wc, _) = results["cuda"], results["cpu"]
    zero = {}
    if model_kw.get("compute_dtype") is not None:
        zero = dict(zero=BF16_ROUNDING_ZERO, zero_floor=BF16_ZERO_FLOOR)
    # Relative to the statistic's norm plus 1e-3 an entry: a running mean that
    # is zero up to rounding (a Dense with a zero bias on centred coordinates)
    # has no relative error to speak of.
    stat_err = {n: float((sg[n] - sc[n]).norm() / (sc[n].norm() + 1e-3 * sc[n].numel() ** 0.5))
                for n in sc}
    return {
        "loss_diff": abs(lg - lc),
        "grad_units": grad_error_units(gg, gc, **zero),
        "grad_l2": float(torch.sqrt(sum(((gg[n] - gc[n]).double() ** 2).sum() for n in gc))
                         / torch.sqrt(sum((g.double() ** 2).sum() for g in gc.values()))),
        "stat": max(stat_err.items(), key=lambda kv: kv[1]),
        "launches": {k: v for k, v in launches.items() if v},
        "launches_bf16": {k: v for k, v in bf16.items() if v},
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
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import create_train_state

    spec, cfg = PATHS[path], path_config(path)
    B, points = spec["batch"], spec["points"]
    arrays = train_arrays(path, cfg)
    steps_per_epoch = len(arrays[0]) // B
    cuda = torch.device("cuda")

    # Timed steps, with the launch counts of exactly those steps, and one more
    # that records the backward launches' inputs and the step's gathers
    # (forward, and the scatter-means' backward) for phase 3.
    run = timed_steps(path, fresh_model(path))
    times, losses, launches, recorded = (run["times"], run["losses"], run["launches"][0],
                                         run["recorded"])
    for i, (dt, loss) in enumerate(zip(times, losses)):
        log(f"[{tag}] step {i}: B={B} x {points} pts, loss {loss:.4f}, "
            f"{dt * 1e3:.3f} ms, {B / dt:.1f} clouds/s")
    log(f"[{tag}] launches over {TRAIN_STEPS} steps: {launches}; peak memory "
        f"{run['peak'] / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    check_launches(tag, launches, spec["per_train_step"], TRAIN_STEPS, "train step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train losses {losses}")
    del run

    # Ten steps on one fixed batch must lower the loss.
    state = create_train_state(fresh_model(path), cfg, cuda)
    step = make_step(path, steps_per_epoch)
    x, y = cli_train.make_inputs(cfg, tuple(a[:B] for a in arrays), cuda)
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


def serve_loader(path: str, device=None, **kw):
    """The serving entry point of ``path`` with this script's seed; ``kw``
    (``compute_dtype``) reach the loader."""
    from mpa_tpu_torch.serve import (
        load_classifier, load_completer, load_pose_regressor, load_segmenter,
        load_semantic_segmenter,
    )

    spec = path_spec(path)
    loader = load_segmenter if path.startswith("partseg") else {
        "semseg": load_semantic_segmenter, "pose": load_pose_regressor,
        "completion": load_completer}.get(path, load_classifier)
    return loader(spec["preset"], seed=SEED, device=device, **spec.get("overrides", {}), **kw)


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
    sum to 1; rotations (orthonormal, determinant 1); the coarse and fine
    clouds, finite; or DGCNN's logits, finite."""
    cfg = path_config(path)
    if path == "dgcnn":  # logits, as mpa_tpu's DGCNN answers
        if tuple(out.shape) != (B, cfg.num_classes) or not torch.isfinite(out).all():
            raise AssertionError(f"[{path}] bad logits {tuple(out.shape)}")
        return
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
    if path.startswith("partseg") or path == "semseg":
        shape = (B, points, cfg.num_parts if path.startswith("partseg") else cfg.num_classes)
    else:
        shape = (B, cfg.num_classes)
    if tuple(out.shape) != shape or not torch.isfinite(out).all():
        raise AssertionError(f"[{path}] bad output {tuple(out.shape)}")
    torch.testing.assert_close(out.exp().sum(-1), torch.ones(shape[:-1], device=out.device),
                               rtol=0, atol=1e-4)


def request_inputs(path: str) -> list:
    """``REQUESTS + 1`` requests of ``path`` at its batch and points: the
    arguments of its serving entry point, made with numpy from ``SEED``."""
    from mpa_tpu_torch.data import realistic_partseg, surface_clouds, synthetic_semseg

    spec = path_spec(path)
    B, points = spec["batch"], spec["points"]
    if path == "semseg":
        blocks, _ = synthetic_semseg(1, points, seed=SEED)  # 24 blocks of one room
        requests = [(blocks[i * B:(i + 1) * B],) for i in range(REQUESTS + 1)]
    elif path.startswith("partseg"):
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
    return requests


def timed_requests(serve, path: str) -> tuple:
    """Two warm-up and ``REQUESTS`` timed requests of ``path`` through
    ``serve``: their seconds and answers, the launch counts of exactly those
    requests (all, and bf16), and every launch's inputs of one more request
    of the same shapes, for the replays (recording keeps them alive, so it
    stays out of the timed ones)."""
    from mpa_tpu_torch import kernels

    requests = request_inputs(path)
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
    launches = (dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BF16))
    kernels.recorded = []
    serve(*requests[1])
    recorded, kernels.recorded = kernels.recorded, None
    return latencies, outputs, launches, recorded


def timed_steps(path: str, model: torch.nn.Module) -> dict:
    """The path's train step of ``model`` on the card at its batch: two
    warm-up and ``TRAIN_STEPS`` timed steps, with their seconds, losses,
    launch counts (all, and bf16) and peak memory, then one more step whose
    backward launches and gathers are recorded for the replays."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import create_train_state

    B, cfg = path_spec(path)["batch"], path_config(path)
    arrays = train_arrays(path, cfg)
    cuda = torch.device("cuda")

    def batch(i):
        return cli_train.make_inputs(cfg, tuple(a[i * B:(i + 1) * B] for a in arrays), cuda)

    state = create_train_state(model, cfg, cuda)
    step = make_step(path, len(arrays[0]) // B)
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
    out = {"times": times, "losses": losses, "peak": torch.cuda.max_memory_allocated(),
           "launches": (dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BF16)), "state": state}
    kernels.recorded = []
    step(state, *batch(TRAIN_WARMUP + TRAIN_STEPS))
    torch.cuda.synchronize()
    out["recorded"] = [(n, inp) for n, inp in kernels.recorded
                       if n in BACKWARD or n == "gather_rows_kernel"]
    kernels.recorded = None
    return out


def serve_phase(path: str, tag: str) -> dict:
    """Phases 2, 2c, 2e, 2g, 2i, 2k, 2m and 2o: the path's serving entry point
    answers two warm-up and ``REQUESTS`` timed requests on the card; launch
    counts, well-formed answers, and the card against the CPU."""
    spec = path_spec(path)
    B, points = spec["batch"], spec["points"]
    latencies, outputs, (launches, _), recorded = timed_requests(serve_loader(path), path)

    for i, lat in enumerate(latencies):
        log(f"[{tag}] request {i}: B={B} x {points} pts, {lat * 1e3:.3f} ms, "
            f"{B / lat:.1f} clouds/s")
    log(f"[{tag}] launches over {REQUESTS} requests: {launches}")
    check_launches(tag, launches, spec["per_forward"], REQUESTS, "request")
    for out in outputs:
        check_served_output(path, out, B, points)
    if path.startswith("partseg") or path in ("semseg", "pose", "completion"):
        if path == "semseg":
            report, limits = semseg_parity(), SEMSEG_LIMITS
        elif path.startswith("partseg"):
            report, limits = (segmenter_parity(preset=spec["preset"], **spec.get("overrides", {})),
                              SEG_LIMITS)
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
        want = cpu(*request_inputs(path)[1])
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
        f"pts, losses {out['losses']}, epoch seconds {out['epoch_seconds']}, clouds/s "
        f"{out['clouds_per_s']}; eval block-mIoU "
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
    return {"train": train_launches, "scene": scene_launches,
            "epoch_seconds": out["epoch_seconds"], "clouds_per_s": out["clouds_per_s"],
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
    from mpa_tpu_torch.kernels import SOURCES

    source, replaces = SOURCES[name], REPLACES[name]
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
        f"{out['steps']} steps, losses {out['losses']}, epoch seconds {out['epoch_seconds']}, "
        f"clouds/s {out['clouds_per_s']}, "
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
        f"over the median of the pass seconds {res['pass_seconds']}); train epoch seconds "
        f"{out['epoch_seconds']}, clouds/s {out['clouds_per_s']}")
    return {"train": train_launches, "eval": launches, "clouds_s": clouds_s,
            "epoch_seconds": out["epoch_seconds"], "clouds_per_s": out["clouds_per_s"],
            "checkpoint": ckpt_dir}


# Faults for ``--planted-faults``, a line or two each: (path whose --parity
# readings the copy gives, file, text, replacement); "none" gives every
# path's.
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
        "const float dw = __fmul_rn(__fdiv_rn(1.f, cnt), load1(gctx + orow + oc));",
        "const float dw = load1(gctx + orow + oc);"),
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
    "data parallel: gradients summed over the ranks, not averaged": (
        "dp", "mpa_tpu_torch/parallel/mesh.py",
        "    flat /= size\n",
        "    flat /= 1\n"),
    "data parallel: step 2's gradients halved": (
        "dp", "mpa_tpu_torch/parallel/mesh.py",
        "    flat /= size\n",
        "    average_gradients.calls = getattr(average_gradients, 'calls', 0) + 1\n"
        "    flat /= size * average_gradients.calls\n"),
    "bf16 scatter-mean: the sum rounded to bf16 after every add": (
        "bf16", "mpa_tpu_torch/kernels/csrc/scatter_index.cuh",
        "              if (j + u < j1) add_row(acc, r[u]);\n",
        "              if (j + u < j1) {\n"
        "                add_row(acc, r[u]);\n"
        "                if constexpr (!kF32)\n"
        "                  for (int v = 0; v < VEC; ++v)\n"
        "                    acc.x[v] = __bfloat162float(__float2bfloat16_rn(acc.x[v]));\n"
        "              }\n"),
    "bf16 attention forward: the denominator rounded to bf16": (
        "bf16", "mpa_tpu_torch/kernels/csrc/attention_fwd.cuh",
        "const float den = fmaxf(denom, kEps);",
        "const float den = std::is_same<T, float>::value ? fmaxf(denom, kEps)\n"
        "          : __bfloat162float(__float2bfloat16_rn(fmaxf(denom, kEps)));"),
    "bf16 windowed scatter-mean backward: the gradient over the count rounded to bf16": (
        "bf16", "mpa_tpu_torch/ops/window.py",
        "return stored(scatter_mean_bwd_cuda(grad, knn_idx, count), grad), None, None, None",
        "return stored(scatter_mean_bwd_cuda(grad, knn_idx, count.to(grad.dtype)), grad), "
        "None, None, None"),
    "bf16 windowed attention forward: the value shift left out": (
        "bf16", "mpa_tpu_torch/kernels/csrc/window_attention.cu",
        "  mpa::attention_fwd_body<KMAX, VEC>(packed, idx, shifts, out, N, S, K, n_branches, C);",
        "  mpa::attention_fwd_body<KMAX, VEC>(packed, idx,\n"
        "                                     std::is_same<T, float>::value ? shifts : nullptr,\n"
        "                                     out, N, S, K, n_branches, C);"),
    "kNN streaming form: the base norms without their last channel": (
        "dgcnn", "mpa_tpu_torch/kernels/csrc/knn_search.cuh",
        "for (int c = 1; c < C; ++c) n2 = __fadd_rn(n2, __fmul_rn(xr[c], xr[c]));",
        "for (int c = 1; c < C - 1; ++c) n2 = __fadd_rn(n2, __fmul_rn(xr[c], xr[c]));"),
    "scatter-add: each cloud's last edge left out, on DGCNN's step": (
        "dgcnn", "mpa_tpu_torch/kernels/csrc/scatter_add.cu",
        "idx + e0, 0, E, 1,",
        "idx + e0, 0, E - 1, 1,"),
    "data parallel: step 2's all-reduce missed": (
        "dp", "mpa_tpu_torch/parallel/mesh.py",
        "    dist.all_reduce(flat, group=group)\n",
        "    average_gradients.calls = getattr(average_gradients, 'calls', 0) + 1\n"
        "    if average_gradients.calls == 1:\n"
        "        dist.all_reduce(flat, group=group)\n"),
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
    ``semseg``, ``repsurf``, ``partseg_fp``, ``pose``, ``completion`` or
    ``dgcnn``), replays of its newest kernels (for the last four: every
    launch of the served request) and of the card step's scatter-adds, each check's
    failure caught and reported; for ``dp``, phase 7a's readings
    (``dp_readings``) and the names of the limits they exceed."""
    from mpa_tpu_torch import kernels

    if path == "dp":
        with tempfile.TemporaryDirectory() as tmp:
            readings, failures, _ = dp_readings(Path(tmp))
        return {**readings, "failures": failures}
    if path == "bf16":
        return bf16_readings()
    out = {}
    seg, limits = {"dgcnn": (dgcnn_parity, DGCNN_LIMITS),
                   "partseg": (segmenter_parity, SEG_LIMITS),
                   "semseg": (semseg_parity, SEMSEG_LIMITS),
                   "repsurf": (repsurf_parity, REPSURF_LIMITS),
                   "partseg_fp": (lambda: segmenter_parity(preset="shapenetpart_fp"), SEG_LIMITS),
                   "pose": (lambda: cloud_parity("pose"), CLOUD_LIMITS),
                   "completion": (lambda: cloud_parity("completion"), CLOUD_LIMITS)}[path]
    seg = seg()
    out["served"] = {k: seg[k] for k in ("median_abs", "p99_abs", "max_abs", "argmax_agreement")
                     if k in seg}
    out["served_within_limits"] = within(seg, limits)
    kernels.recorded = []
    parity = train_parity(path)
    recorded, kernels.recorded = kernels.recorded, None
    out["train"] = {"loss_diff": parity["loss_diff"], "grad_units": parity["grad_units"][:3],
                    "stat": parity["stat"]}
    scatter_adds = [inp for name, inp in recorded if name == "scatter_add_rows_kernel"]
    if path in ("partseg_fp", "pose", "completion", "dgcnn"):
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


def bf16_readings() -> dict:
    """``--parity bf16``: phase 8's card-against-CPU readings of each bf16
    path (cls, part-seg and part-seg in the window modes; served and one
    train step) and the replays of every bf16 launch of each parity request
    (the scatter-means' backward too) and of the backward of each parity
    step, each check's failure caught and reported."""
    from mpa_tpu_torch import kernels

    out = {}
    for path in BF16_PATHS:
        rep = bf16_served_parity(path)
        recorded = rep.pop("recorded")
        out[f"{path}_served"] = {k: rep[k] for k in ("max_abs", "median_abs", "p99_abs",
                                                     "argmax_agreement")}
        out[f"{path}_served_within_limits"] = within(rep, BF16_LIMITS[path])
        kernels.recorded = []
        try:
            parity = train_parity(path, compute_dtype=torch.bfloat16)
        finally:
            trained, kernels.recorded = kernels.recorded, None
        out[f"{path}_train"] = {"loss_diff": parity["loss_diff"], "grad_l2": parity["grad_l2"],
                                "grad_units": parity["grad_units"][:3]}
        out[f"{path}_train_within_limits"] = bf16_step_within(path, parity)
        launches = [(n, inp) for n, inp in recorded if not _f32_launch(n, inp)]
        launches += [(n, inp) for n, inp in trained if n in BACKWARD and not _f32_launch(n, inp)]
        failures = []
        for name, inp in launches:
            try:
                check_call(name, inp)
                if name in ("scatter_mean_kernel", "windowed_scatter_mean_kernel"):
                    check_scatter_mean_grad(inp)
            except AssertionError as e:
                failures.append(f"{name}: " + str(e).splitlines()[0][:120])
        out[f"{path}_replays"] = f"{len(launches)} bf16 launches, {len(failures)} fail"
        if failures:
            out[f"{path}_replay_failures"] = failures[:5]
    return out


def planted_faults(only: str = "all") -> None:
    """``--planted-faults [PATH]``: for each entry of ``PLANTED_FAULTS`` (of
    path ``only``, or all), a copy of the port in a temporary directory with
    that one line changed runs ``chip_smoke.py --parity`` for the fault's
    path (the copy without a fault for each such path); prints each copy's
    readings. The limits of ``SEG_LIMITS``, ``SEMSEG_LIMITS``,
    ``REPSURF_LIMITS``, ``DGCNN_LIMITS``, ``grad_limit`` and ``DP_LIMITS``
    lie between a correct copy's readings and the faulty ones'."""
    parity_paths = ["partseg", "semseg", "repsurf", "dp", "bf16", "dgcnn"]
    if only != "all":
        parity_paths = [only]
    with tempfile.TemporaryDirectory() as tmp:
        for name, fault in PLANTED_FAULTS.items():
            if fault is not None and fault[0] not in parity_paths:
                continue
            root = Path(tmp) / re.sub(r"\W+", "_", name)
            # the built library too: a fault in a kernel source changes the
            # sources' hash, and the copy builds its own
            shutil.copytree(REPO / "mpa_tpu_torch", root / "mpa_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
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
                saved = REPO / "chiprun_out" / "planted" / f"{root.name}_{path}.json"
                saved.parent.mkdir(parents=True, exist_ok=True)
                saved.write_text(last)
                log(f"[planted] {name} ({path}): exit {proc.returncode} "
                    f"{last[:2000] or proc.stderr[-400:]} (all of it in {saved})")


# Phase 7: data parallelism and the trainer's surface on the card. Two ranks
# share the one card (NCCL refuses two ranks on one device, so they meet
# over gloo), each with half of the cls batch; one process takes the whole.
# Both take SGD at the preset's rate: Adam's first step is lr times the
# sign of each gradient entry, so the entries whose gradient is zero up to
# rounding (3% of them after two steps at B = 8 on the CPU) would move by
# +-lr on one side only, which says nothing about the data parallelism.
DP_RANKS, DP_STEPS = 2, 2


def dp_config():
    return path_config("cls").with_overrides(optimizer="sgd")


def reference_checkpoint(task: str, model: torch.nn.Module, seed: int = SEED) -> dict:
    """A state dict in the reference's layout for ``model`` (``'cls'``: a
    port ``MarkovClassifier``, ``'partseg'``: a ``MarkovPartSeg``): every key
    of ``torch_import.reference_keys`` at the port tensor's shape, drawn
    from ``default_rng(seed)`` (Linear weights at ``1/sqrt(fan_in)``, running
    variances in ``[0.5, 1.5)``), and the keys a reference checkpoint holds
    that the model does not read: the LayerNorm ``norm1`` beside each
    BatchNorm ``norm2``, the BatchNorm counters and a ``normal_Trans`` in
    each LocalMerge."""
    from mpa_tpu_torch.utils.torch_import import reference_keys

    rng = np.random.default_rng(seed)
    own = model.state_dict()
    sd = {}
    for key, ref in reference_keys(task, model).items():
        shape = tuple(own[key].shape)
        if ref.endswith("running_var"):
            value = rng.uniform(0.5, 1.5, shape)
            sd[ref[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
        elif ref.endswith("weight") and len(shape) == 2:
            value = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif ref.endswith("weight"):
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = 0.1 * rng.standard_normal(shape)
        sd[ref] = torch.from_numpy(value.astype(np.float32))
        if ".norm2." in ref and ref.endswith(".weight"):
            site = ref[:-len("norm2.weight")]
            sd[site + "norm1.weight"] = torch.ones(shape)
            sd[site + "norm1.bias"] = torch.zeros(shape)
        if ".xyz_Trans.k.weight" in ref:
            merge = ref[:ref.index("xyz_Trans.")]
            sd[merge + "normal_Trans.k.weight"] = torch.zeros(4, 3)
    return sd


def dp_steps(weights: str, rank: int, ranks: int, device: torch.device) -> dict:
    """``DP_STEPS`` steps of the cls path (``scanobjectnn_cls`` with SGD,
    ``dp_config``, dropout 0) from ``weights`` on ``device``, over the first
    global batches of its training set: this rank's rows through the
    data-parallel step when ``ranks > 1`` (a group is joined), the whole
    batch through the plain step otherwise. Returns each step's loss,
    (averaged) gradients and the state after it, and the kernel launches."""
    from mpa_tpu_torch import kernels, parallel
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.data.pipeline import host_shard
    from mpa_tpu_torch.train import TRAIN_STEPS, create_train_state

    spec, cfg = PATHS["cls"], dp_config()
    B = spec["batch"]
    model = fresh_model("cls", dropout=0.0)
    model.load_state_dict(torch.load(weights, weights_only=True))
    state = create_train_state(model, cfg, device)
    arrays = train_arrays("cls", cfg)
    if ranks > 1:
        parallel.replicate(parallel.sync_batchnorm(state.model))
        step = parallel.make_data_parallel_train_step(cfg, len(arrays[0]) // B)
    else:
        step = TRAIN_STEPS[cfg.task](cfg, len(arrays[0]) // B)
    kernels.reset_launch_counts()
    losses, grads, states = [], [], []
    for i in range(DP_STEPS):
        batch = host_shard(tuple(a[i * B:(i + 1) * B] for a in arrays), B, rank, ranks)
        losses.append(float(step(state, *cli_train.make_inputs(cfg, batch, device))))
        # copies: on the CPU, .cpu() would hand back the live tensors
        grads.append({n: p.grad.detach().to("cpu", copy=True)
                      for n, p in state.model.named_parameters()})
        states.append({k: v.detach().to("cpu", copy=True)
                       for k, v in state.model.state_dict().items()})
    return {"losses": losses, "grads": grads, "states": states,
            "launches": dict(kernels.LAUNCHES)}


def dp_rank_main(rank: int, init_file: str, weights: str, out: str) -> None:
    """One rank of phase 7a, in a spawned process on ``cuda:0``."""
    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from mpa_tpu_torch import parallel

    parallel.init("gloo", device=torch.device("cuda", 0), init_method=f"file://{init_file}",
                  rank=rank, world_size=DP_RANKS, timeout_s=300)
    try:
        torch.save(dp_steps(weights, rank, DP_RANKS, torch.device("cuda", 0)), out)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# Phase 7a's limits. Step 1: the loss (absolute), the averaged gradients in
# ``grad_limit`` units, the running statistics (relative, as
# ``train_parity``'s). After the last step, each measured against the
# reference's own motion, so that the limit scales with the update: the
# parameters' largest distance from the reference over the reference's
# largest move from the initial weights (``param_rel``), the same in L2 over
# all parameters (``param_rel_l2``: a near-tie flip moves a few entries, a
# fault in the update all of them), the running statistics' largest
# distance over their largest move, and the loss's distance over the
# reference loss's move from step 1. PERF.md §6 has the sound and the
# planted-fault readings beside them.
DP_LIMITS = {"loss1_abs": 1e-4, "stat1_rel": 1e-4, "param_rel": 0.18, "param_rel_l2": 0.18,
             "stat_rel": 0.01, "loss_rel": 0.1}


def _largest_move(a: dict, b: dict, names) -> tuple:
    """``(name, max |a[n] - b[n]|)`` of the name where it is largest."""
    return max(((n, float((a[n] - b[n]).abs().max())) for n in names), key=lambda kv: kv[1])


def dp_readings(work: Path) -> tuple:
    """Phase 7a's run and readings: two gloo ranks on the one card, B = 32
    each, against one process on the whole batch of 64 x 1024 with the plain
    ops on the CPU, the reference ``train_parity`` holds the card to.
    Returns ``(readings, failures, launches of each rank)``: every reading
    is taken before any is held, so a planted fault's are all printed."""
    import multiprocessing

    weights = str(work / "dp_init.pt")
    init = fresh_model("cls", dropout=0.0).state_dict()
    torch.save(init, weights)
    ctx = multiprocessing.get_context("spawn")
    outs = [str(work / f"dp_rank{r}.pt") for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dp_rank_main, args=(r, str(work / "dp_rendezvous"), weights,
                                                     outs[r])) for r in range(DP_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(timeout=30)
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"[7a dp] ranks exited {[p.exitcode for p in procs]}"
                             f"{' (hung)' if hung else ''}")
    ranks_s = time.perf_counter() - t0
    got = [torch.load(o, weights_only=False) for o in outs]
    t0 = time.perf_counter()
    want = dp_steps(weights, 0, 1, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    first, last = got[0]["states"][0], got[0]["states"][-1]
    want_first, want_last = want["states"][0], want["states"][-1]
    params = [n for n, _ in fresh_model("cls").named_parameters()]
    running = [n for n in want_last if "running" in n]
    units = grad_error_units(got[0]["grads"][0], want["grads"][0])[0]
    stats = {n: float((first[n] - want_first[n]).norm()
                      / (want_first[n].norm() + 1e-3 * want_first[n].numel() ** 0.5))
             for n in running}
    stat1 = max(stats.items(), key=lambda kv: kv[1])
    param_off, param_move = _largest_move(last, want_last, params), _largest_move(
        want_last, init, params)
    param_l2 = (sum(float((last[n] - want_last[n]).double().square().sum()) for n in params)
                / sum(float((want_last[n] - init[n]).double().square().sum()) for n in params)
                ) ** 0.5
    stat_off, stat_move = _largest_move(last, want_last, running), _largest_move(
        want_last, init, running)
    loss_off = abs(got[0]["losses"][-1] - want["losses"][-1])
    loss_move = abs(want["losses"][-1] - want["losses"][0])
    ranks_apart = max(float((a[n] - b[n]).abs().max())
                      for a, b in zip(got[0]["states"], got[1]["states"]) for n in a)
    r = {"losses": got[0]["losses"], "want_losses": want["losses"],
         "loss1_abs": abs(got[0]["losses"][0] - want["losses"][0]),
         "grad_units": units, "stat1_rel": stat1,
         "param_off": param_off, "param_move": param_move,
         "param_rel": param_off[1] / param_move[1], "param_rel_l2": param_l2,
         "stat_off": stat_off, "stat_move": stat_move, "stat_rel": stat_off[1] / stat_move[1],
         "loss_off": loss_off, "loss_move": loss_move, "loss_rel": loss_off / loss_move,
         "ranks_apart": ranks_apart, "ranks_s": ranks_s, "cpu_s": cpu_s}
    failures = [k for k in ("loss1_abs", "param_rel", "param_rel_l2", "stat_rel", "loss_rel")
                if r[k] > DP_LIMITS[k]]
    if units[1] > PATHS["cls"]["grad_limit"]:
        failures.append("grad_units")
    if stat1[1] > DP_LIMITS["stat1_rel"]:
        failures.append("stat1_rel")
    if ranks_apart != 0.0:
        failures.append("ranks_apart")
    return r, failures, [res["launches"] for res in got]


def dp_phase(tag: str, work: Path) -> dict:
    """7a (``dp_readings``), held: step 1's loss, averaged gradients and
    running statistics (means and biased variances) against the one
    process's; after step ``DP_STEPS`` the parameters, the running
    statistics and the loss, each within ``DP_LIMITS`` of the reference's
    own motion (in float32 the first step's rounding flips near-tie
    selections, feature kNN and max over K, in the second, CPU against CPU
    too, so step 2 reads as far off as its rounding takes it; in float64
    two ranks and one process agree within 1e-15,
    ``tests/test_torch_port_parallel.py``). The ranks hold bit-equal
    states, and each rank's launches are exactly ``DP_STEPS`` cls train
    steps'."""
    spec = PATHS["cls"]
    r, failures, launches = dp_readings(work)
    log(f"[{tag}] {DP_RANKS} gloo ranks on cuda:0, B={spec['batch']} x {spec['points']} "
        f"split in halves, {DP_STEPS} SGD steps ({r['ranks_s']:.1f} s with the processes' "
        f"start), against one process on the CPU ({r['cpu_s']:.1f} s): losses {r['losses']} "
        f"vs {r['want_losses']}; step 1: loss |d| {r['loss1_abs']:.3e} (limit "
        f"{DP_LIMITS['loss1_abs']}), gradient units {r['grad_units'][0]} "
        f"{r['grad_units'][1]:.3f} (limit {spec['grad_limit']}), worst statistic "
        f"{r['stat1_rel'][0]} rel {r['stat1_rel'][1]:.3e} (limit {DP_LIMITS['stat1_rel']}); "
        f"after step {DP_STEPS}: parameters {r['param_off'][0]} {r['param_off'][1]:.3e} off "
        f"over a move of {r['param_move'][1]:.3e} ({r['param_move'][0]}) = "
        f"{r['param_rel']:.4f} (limit {DP_LIMITS['param_rel']}), in L2 {r['param_rel_l2']:.4f} "
        f"(limit {DP_LIMITS['param_rel_l2']}), statistics "
        f"{r['stat_off'][0]} {r['stat_off'][1]:.3e} over {r['stat_move'][1]:.3e} "
        f"({r['stat_move'][0]}) = {r['stat_rel']:.4f} (limit {DP_LIMITS['stat_rel']}), loss "
        f"{r['loss_off']:.3e} over {r['loss_move']:.3e} = {r['loss_rel']:.4f} (limit "
        f"{DP_LIMITS['loss_rel']}); ranks apart {r['ranks_apart']:.3e}; launches a rank "
        f"{launches[0]}")
    for rank, counts in enumerate(launches):
        check_launches(f"{tag} rank {rank}", counts, spec["per_train_step"], DP_STEPS,
                       "train step")
    if failures:
        raise AssertionError(f"[{tag}] two ranks differ from one process: {failures}")
    return {f"dp_rank{rank}_train": counts for rank, counts in enumerate(launches)}


def ddp_cli_phase(tag: str, work: Path) -> tuple:
    """7b: ``cli.train --init xavier`` three steps under a one-rank NCCL
    group that it joins from torchrun's environment (set here, taken away
    after), its launches exactly three steps' and its eval's, the first
    step's replayed (tag ``ddp``)."""
    import os

    import torch.distributed as dist

    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train

    spec = PATHS["cls"]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    os.environ.update(env)
    kernels.reset_launch_counts()
    kernels.recorded = FirstLaunches(sum(spec["per_train_step"].values()))
    try:
        _, out = cli_train.run(cli_train.parse_args(
            ["--preset", spec["preset"], "--device", "cuda", "--max_steps", "3", "--seed",
             str(SEED), "--init", "xavier", "--eval_clouds", str(spec["batch"]),
             "--log_dir", str(work / "ddp_runs")]))
        torch.cuda.synchronize()
    finally:
        recorded, kernels.recorded = kernels.recorded, None
        for k in env:
            os.environ.pop(k, None)
    launches = dict(kernels.LAUNCHES)
    if dist.is_initialized():
        raise AssertionError(f"[{tag}] cli.train left its process group behind")
    want = {k: 3 * spec["per_train_step"].get(k, 0) + 3 * spec["per_forward"].get(k, 0)
            for k in kernels.KERNELS}  # three steps, one eval batch of three votes
    log(f"[{tag}] cli.train under a 1-rank NCCL group, --init xavier: {out['steps']} steps, "
        f"losses {out['losses']}, epoch seconds {out['epoch_seconds']}, clouds/s "
        f"{out['clouds_per_s']}; launches {launches}")
    check_launches(f"{tag} train", launches, want, 1, "run")
    if out["steps"] != 3 or not np.isfinite(out["losses"]).all() or "instance_acc" not in out:
        raise AssertionError(f"[{tag}] cli.train: {out}")
    if not (work / "ddp_runs" / f"{spec['preset']}_synthetic" / "train_metrics.jsonl").exists():
        raise AssertionError(f"[{tag}] no train_metrics.jsonl")
    rows = [replay_call("ddp", name, inp) for name, inp in recorded]
    return launches, rows


def import_phase(tag: str, work: Path) -> dict:
    """7c: a reference-layout ``best_model.pth`` (``reference_checkpoint``)
    at the cls path's full width through ``cli.train --import_torch`` (lr 0,
    so the trained parameters stay the imported ones: bit-equal) and
    ``cli.eval --import_torch``; the imported model's served log-probs on
    the card against the CPU's within ``CLOUD_LIMITS`` and against the CPU
    in float64 within ``IMPORT_F64_LIMIT`` (the float32 CPU's distance from
    float64 is read beside it), and the log-probs' scale."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import eval as cli_eval
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import make_eval_step
    from mpa_tpu_torch.utils.torch_import import import_reference_checkpoint

    spec, cfg = PATHS["cls"], path_config("cls")
    pth = work / "best_model.pth"
    torch.save({"epoch": 7, "model_state_dict": reference_checkpoint("cls", fresh_model("cls"))},
               pth)
    kernels.reset_launch_counts()
    state, out = cli_train.run(cli_train.parse_args(
        ["--preset", spec["preset"], "--device", "cuda", "--max_steps", "2", "--seed",
         str(SEED), "--import_torch", str(pth), "--learning_rate", "0", "--eval_clouds",
         str(spec["batch"]), "--log_dir", str(work / "import_runs")]))
    launches = dict(kernels.LAUNCHES)
    imported = fresh_model("cls")
    import_reference_checkpoint(str(pth), "cls", imported)
    trained = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    same = all(torch.equal(trained[n], p) for n, p in imported.named_parameters())
    res = cli_eval.main(["--preset", spec["preset"], "--device", "cuda", "--import_torch",
                         str(pth), "--num_votes", "1", "--batch_size", str(spec["batch"]),
                         "--log_dir", str(work / "import_runs")])
    x = torch.from_numpy(train_arrays("cls", cfg)[0][:spec["parity_batch"]])
    eval_step = make_eval_step()
    outs = {}
    for name, device, dtype in (("cuda", torch.device("cuda"), torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("cpu64", torch.device("cpu"), torch.float64)):
        st = cli_eval.eval_state(cfg, device)
        import_reference_checkpoint(str(pth), "cls", st.model)
        st.model.to(dtype)
        outs[name] = eval_step(st, x.to(device, dtype)).cpu().double()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    err64 = {k: (outs[k] - outs["cpu64"]).abs().max().item() for k in ("cuda", "cpu")}
    scale = outs["cpu64"].abs().max().item()
    log(f"[{tag}] cli.train --import_torch (lr 0, {out['steps']} steps): parameters "
        f"{'bit-equal to' if same else 'differ from'} the imported ones; cli.eval "
        f"--import_torch vote-acc {res['vote_acc']:.4f} over {res['clouds']} clouds; served "
        f"card vs cpu at B={spec['parity_batch']}: max |dlogp| {err:.3e} (limit "
        f"{CLOUD_LIMITS['max_abs']}); against the CPU in float64: card {err64['cuda']:.3e} "
        f"(limit {IMPORT_F64_LIMIT}), cpu float32 {err64['cpu']:.3e}; log-prob scale max "
        f"|logp| {scale:.3e}, so card vs cpu {err / scale:.3e} of it")
    if (not same or err > CLOUD_LIMITS["max_abs"] or err64["cuda"] > IMPORT_F64_LIMIT
            or not np.isfinite(out["losses"]).all()):
        raise AssertionError(f"[{tag}] the imported weights did not carry through")
    return launches


def keyed_phase(tag: str) -> tuple:
    """7d: one train step each of cls (its encoder's ``fps_random_start``
    set) and part-seg, exact and in ``window_all``, with keyed FPS starts
    drawn on the card from ``TrainState.fps_generator``; every ``fps_kernel`` launch replayed
    against ``fps_plain`` with its starts (``[B]``, the banded ones folded
    to ``[B * n_bands]``), the cls and exact part-seg steps' launches exactly
    ``per_train_step``'s."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import create_train_state

    cuda, rows, counts = torch.device("cuda"), [], {}
    cases = {"cls": ("cls", {}), "partseg": ("partseg", {}),
             "partseg_window_all": ("partseg", dict(neighbor_mode="window_all"))}
    for case, (path, over) in cases.items():
        spec = PATHS[path]
        cfg = path_config(path).with_overrides(**over)
        arrays = train_arrays(path, cfg)
        model = fresh_model(path, cfg)
        if path == "cls":
            model.keep_high.fps_random_start = True
        state = create_train_state(model, cfg, cuda)
        state.fps_generator = torch.Generator(device=cuda).manual_seed(SEED)
        step = make_step(path, len(arrays[0]) // spec["batch"])
        inputs, labels = cli_train.make_inputs(
            cfg, tuple(a[:spec["batch"]] for a in arrays), cuda)
        kernels.reset_launch_counts()
        kernels.recorded = []
        try:
            loss = float(step(state, inputs, labels))
        finally:
            recorded, kernels.recorded = kernels.recorded, None
        counts[f"keyed_{case}"] = dict(kernels.LAUNCHES)
        if case != "partseg_window_all":
            check_launches(f"{tag} {case}", counts[f"keyed_{case}"], spec["per_train_step"], 1,
                           "train step")
        fps = [inp for name, inp in recorded if name == "fps_kernel"]
        starts = [inp["start"] for inp in fps]
        if len(fps) != spec["per_forward"]["fps_kernel"] or not all(
                torch.is_tensor(s) and s.device.type == "cuda" for s in starts):
            raise AssertionError(f"[{tag}] {case}: FPS launches without keyed starts")
        if not any(int(s.max()) > 0 for s in starts):
            raise AssertionError(f"[{tag}] {case}: every start is 0")
        log(f"[{tag}] {case} step with keyed starts: loss {loss:.4f}, start shapes "
            f"{[tuple(s.shape) for s in starts]}")
        if not np.isfinite(loss):
            raise AssertionError(f"[{tag}] {case}: loss {loss}")
        rows += [replay_call(f"keyed_{case}", "fps_kernel", inp) for inp in fps]
        del state
    return counts, rows


def phase7(work: Path) -> tuple:
    """Phase 7 (module doc): the launch counts of each run, the replays."""
    counts = dp_phase("7a dp", work)
    counts["ddp_cli"], rows = ddp_cli_phase("7b ddp", work)
    counts["import_cli"] = import_phase("7c import", work)
    keyed_counts, keyed_rows = keyed_phase("7d keyed")
    counts.update(keyed_counts)
    return counts, rows + keyed_rows


# Phase 8: mixed precision, compute_dtype=torch.bfloat16: markov_cls and
# markov_partseg in the exact neighbour mode, and markov_partseg in the
# ``window`` and ``window_all`` modes, at their paths' widths. Eight
# kernels take bf16 storage; every other kernel sees float32 (the
# coordinates, and the feature kNN, exact or windowed, after its upcast, as
# in mpa_tpu). The launch counts are those of the float32 paths in all
# (``PATHS``, ``WINDOW_PATHS``), and of them the bf16 launches: cls, the
# five center_feat gathers (the five new_xyz gathers are of float32
# coordinates) and every attention call; part-seg in each mode, the four
# center_feat gathers and Fuse's ten finer sources, every attention call
# (windowed or exact) and every scatter-mean. A train step adds the bf16
# backwards: every attention backward and the scatter-add of every bf16
# gather. The scatter-means' backward gathers are float32: the bf16
# gradient divided by the float32 count is float32, as in mpa_tpu.
BF16_CLS_FORWARD = {"gather_rows_kernel": 5, "transition_attention_fwd_kernel": 11}
BF16_PARTSEG_FORWARD = {"gather_rows_kernel": 14, "transition_attention_fwd_kernel": 17,
                        "scatter_mean_kernel": 14}
BF16_PATHS = {
    "cls": dict(per_forward=BF16_CLS_FORWARD,
                per_train_step=dict(BF16_CLS_FORWARD, transition_attention_bwd_kernel=11,
                                    scatter_add_rows_kernel=5)),
    "partseg": dict(per_forward=BF16_PARTSEG_FORWARD,
                    per_train_step=dict(BF16_PARTSEG_FORWARD, transition_attention_bwd_kernel=17,
                                        scatter_add_rows_kernel=14)),
}


def _bf16_window_path(fwd: dict) -> dict:
    """``BF16_PATHS``' entry of a part-seg window mode whose request
    launches ``fwd`` (``PARTSEG_WINDOW_FORWARD``): every attention call and
    scatter-mean, the gathers but the four of float32 coordinates
    (``new_xyz``); a step adds every attention's backward and the fourteen
    scatter-adds."""
    bf16 = dict({k: v for k, v in fwd.items() if "attention" in k or "scatter_mean" in k},
                gather_rows_kernel=fwd["gather_rows_kernel"] - 4)
    backward = {k.replace("_fwd_", "_bwd_"): v for k, v in bf16.items() if "attention_fwd" in k}
    return dict(per_forward=bf16,
                per_train_step=dict(bf16, scatter_add_rows_kernel=14, **backward))


BF16_PATHS.update({f"partseg_{mode}": _bf16_window_path(fwd)
                   for mode, fwd in PARTSEG_WINDOW_FORWARD.items()})
# The bf16 model on the card against the same bf16 model on the CPU (plain
# ops), served on ``parity_batch`` clouds (``BF16_LIMITS``: the log-probs of
# cls, their largest difference; of part-seg, per point, its median and the
# argmax agreement) and one train step there (``BF16_TRAIN_LIMITS``: the
# loss, and the gradients in ``grad_error_units`` with ``BF16_ROUNDING_ZERO``
# and its floor). Both sides round to bf16 at the same places, but cuBLAS
# and the CPU sum a bf16 product's terms in other orders, so a product can
# round to the neighbouring bf16 (2^-8 of its size), and the max over the
# neighbours and the train-mode BatchNorms amplify that: the whole train-mode
# gradient of the card's step is 0.75 (cls) and 0.36 (part-seg) of its norm
# from the CPU's. Each limit lies between a correct run's reading and the
# planted faults' (``--planted-faults bf16``; NVIDIA H100 80GB HBM3, 700 W,
# PERF.md section 6): cls max 2.368e-03 correct, 6.887e-03 with the
# attention forward's denominator rounded to bf16; part-seg median 3.749e-03
# correct, 3.851e-03 with the scatter-mean summing in bf16 and 3.877e-03
# with the denominator fault; loss 6.3e-03 / 3.7e-03 correct, 7.36e-02 (cls,
# denominator) and 6.5e-03 (part-seg, both faults); gradient units 940 / 504
# correct, 1421 / 930 with the denominator fault (the scatter-mean fault
# reads 507 there: the part-seg loss and median limits catch it, and its
# replays). The window modes, ``window`` / ``window_all``, read correct /
# scatter-mean summing in bf16 / denominator / the windowed forward's value
# shift left out: median 3.453e-03 / 3.619e-03 / 4.017e-03 / 0.2526 and
# 3.668e-03 / 3.660e-03 / 3.971e-03 / 0.2517; loss 3.06e-03 / 1.38e-03 /
# 3.20e-02 / 0.379 and 2.17e-02 / 2.06e-02 / 1.35e-02 / 0.110; gradient
# units 534 / 491 / 894 / 3440 and 544 / 550 / 969 / 2368. The windowed
# scatter-mean's backward in bf16 reads as the correct copy there and fails
# its 14 replays (``check_scatter_mean_grad``), as the scatter-mean fault
# does in ``window_all``, whose median lies below the correct one's; the
# window_all loss of a correct step, 2.17e-02, lies above both subtle
# faults', so its loss limit catches only the gross one.
BF16_LIMITS = {"cls": {"max_abs": 4e-3},
               "partseg": {"median_abs": 3.8e-3, "argmax_agreement": 0.99},
               "partseg_window": {"median_abs": 3.55e-3, "argmax_agreement": 0.99},
               "partseg_window_all": {"median_abs": 3.8e-3, "argmax_agreement": 0.99}}
BF16_TRAIN_LIMITS = {"cls": {"loss_abs": 2e-2, "grad_limit": 1150},
                     "partseg": {"loss_abs": 5e-3, "grad_limit": 700},
                     "partseg_window": {"loss_abs": 1e-2, "grad_limit": 700},
                     "partseg_window_all": {"loss_abs": 3e-2, "grad_limit": 700}}


def bf16_step_within(path: str, parity: dict) -> bool:
    """``train_parity``'s bf16 step of ``path`` within ``BF16_TRAIN_LIMITS``."""
    limits = BF16_TRAIN_LIMITS[path]
    return (parity["loss_diff"] <= limits["loss_abs"]
            and parity["grad_units"][0][1] <= limits["grad_limit"])


def bf16_served_parity(path: str) -> dict:
    """The bf16 model of ``path`` served on ``parity_batch`` request clouds
    on the card against the CPU (plain ops) from the same weights:
    ``segmentation_agreement`` (cls: one row a cloud); beside it the card's
    float32 model against its bf16 one (what bf16 costs), and the card's
    bf16 model with cuBLAS's reduced-precision bf16 reduction let on against
    the CPU (what the port's setting, off, is worth). Also every launch of
    the card's bf16 request (``recorded``)."""
    from mpa_tpu_torch import kernels

    spec = path_spec(path)
    req = tuple(a[:spec["parity_batch"]] for a in request_inputs(path)[1])
    bf16 = dict(compute_dtype=torch.bfloat16)
    kernels.recorded = []
    try:
        got = serve_loader(path, **bf16)(*req).cpu()
    finally:
        recorded, kernels.recorded = kernels.recorded, None
    f32 = serve_loader(path)(*req).cpu()
    matmul = torch.backends.cuda.matmul
    reduced = serve_loader(path, **bf16)  # resolve_device sets the flag off: let it on after
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        loose = reduced(*req).cpu()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    want = serve_loader(path, device="cpu", **bf16)(*req)
    cpu_s = time.perf_counter() - t0

    def agree(a, b):
        return segmentation_agreement(a, b) if a.dim() == 3 else segmentation_agreement(a[None],
                                                                                         b[None])

    return dict(agree(got, want), cpu_s=cpu_s, f32_vs_bf16=agree(f32, got),
                reduced_vs_cpu=agree(loose, want), recorded=recorded)


def bf16_phase(path: str, tag: str) -> dict:
    """Phase 8 for ``path`` (a key of ``BF16_PATHS``), module doc: (a) the bf16
    model served, two warm-up and ``REQUESTS`` timed requests, launch counts
    exact in all and in bf16, well-formed answers, the card against the CPU
    within ``BF16_LIMITS``; (b) the preset's train step of the bf16 model,
    two warm-up and ``TRAIN_STEPS`` timed steps with their counts and peak
    memory, and one step at ``parity_batch`` on the card against the CPU
    within ``BF16_TRAIN_LIMITS``' loss and gradient limits; (c) the launches of
    one more request and step, recorded for the replays; (d) the medians."""
    spec, want = path_spec(path), BF16_PATHS[path]
    B, points = spec["batch"], spec["points"]
    bf16 = dict(compute_dtype=torch.bfloat16)

    # (a) served
    latencies, outputs, (launches, launches_bf16), recorded = timed_requests(
        serve_loader(path, **bf16), path)
    log(f"[{tag}] requests ms {[round(t * 1e3, 3) for t in latencies]}: B={B} x {points} pts; "
        f"launches over {REQUESTS} requests {launches}, bf16 among them {launches_bf16}")
    check_launches(tag, launches, spec["per_forward"], REQUESTS, "request")
    check_launches(f"{tag} bf16", launches_bf16, want["per_forward"], REQUESTS, "request")
    for out in outputs:
        if out.dtype != torch.float32:
            raise AssertionError(f"[{tag}] log-probs of type {out.dtype}, want float32")
        check_served_output(path, out, B, points)
    report = bf16_served_parity(path)
    limits = BF16_LIMITS[path]
    log(f"[{tag}] cuda vs cpu, bf16 both, at B={spec['parity_batch']} (plain ops, "
        f"{report['cpu_s']:.1f} s on the host): max |d| {report['max_abs']:.3e}, median "
        f"{report['median_abs']:.3e}, argmax agreement {report['argmax_agreement']:.5f} (limits "
        f"{limits}); card f32 vs card bf16: max {report['f32_vs_bf16']['max_abs']:.3e}, median "
        f"{report['f32_vs_bf16']['median_abs']:.3e}, argmax agreement "
        f"{report['f32_vs_bf16']['argmax_agreement']:.5f}; cuBLAS reduced-precision bf16 "
        f"reduction on, vs cpu: max {report['reduced_vs_cpu']['max_abs']:.3e}, median "
        f"{report['reduced_vs_cpu']['median_abs']:.3e}")
    if not within(report, limits):
        raise AssertionError(f"[{tag}] bf16 cuda and cpu answers differ: {report}")
    served_recorded = recorded + report.pop("recorded")
    torch.cuda.empty_cache()

    # (b) trained, (c) its launches recorded
    run = timed_steps(path, fresh_model(path, **bf16))
    times, losses, peak = run["times"], run["losses"], run["peak"]
    t_launches, t_bf16 = run["launches"]
    log(f"[{tag}] train steps ms {[round(t * 1e3, 3) for t in times]}, losses "
        f"{[round(v, 4) for v in losses]}; peak memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated); launches over {TRAIN_STEPS} steps {t_launches}, "
        f"bf16 among them {t_bf16}")
    check_launches(tag, t_launches, spec["per_train_step"], TRAIN_STEPS, "train step")
    check_launches(f"{tag} bf16", t_bf16, want["per_train_step"], TRAIN_STEPS, "train step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] non-finite train losses {losses}")
    for name, p in run["state"].model.named_parameters():
        if p.dtype != torch.float32 or (p.grad is not None and p.grad.dtype != torch.float32):
            raise AssertionError(f"[{tag}] {name}: parameters and gradients stay float32")
    trained_recorded = run["recorded"]
    del run
    torch.cuda.empty_cache()
    parity = train_parity(path, **bf16)
    train_limits = BF16_TRAIN_LIMITS[path]
    log(f"[{tag}] cuda vs cpu, bf16 both, one step at B={spec['parity_batch']} "
        f"({parity['cuda_s'] * 1e3:.1f} ms on the card, {parity['cpu_s']:.1f} s on the host): "
        f"loss |d| {parity['loss_diff']:.3e} (limit {train_limits['loss_abs']}); gradient "
        f"error in units of grad_error_units with BF16_ROUNDING_ZERO's floor "
        f"(limit {train_limits['grad_limit']}), largest: "
        + ", ".join(f"{n} {u:.3f}" for n, u in parity["grad_units"][:3])
        + f"; whole gradient {parity['grad_l2']:.4f} of its norm apart"
        + f"; worst statistic {parity['stat'][0]} rel {parity['stat'][1]:.3e}")
    if not bf16_step_within(path, parity):
        raise AssertionError(f"[{tag}] the bf16 CUDA train step differs from the CPU step")
    return {"latency_ms": [t * 1e3 for t in latencies], "step_ms": [t * 1e3 for t in times],
            "peak_bytes": peak, "launches": launches, "launches_bf16": launches_bf16,
            "train_launches": t_launches, "train_launches_bf16": t_bf16,
            "recorded": served_recorded, "trained": trained_recorded,
            "served": {k: report[k] for k in ("max_abs", "median_abs", "argmax_agreement")},
            "grad_units": parity["grad_units"][0]}


def bf16_replay(path: str, res: dict) -> list:
    """Phase 8c: every bf16 launch of the bf16 path's recorded request (and
    the parity request's) and of its recorded step, against its plain
    version (``check_call``), tagged ``PATH_bf16``; the step's gathers
    ``PATH_bf16_train``; the scatter-means' backward as phase 3's."""
    rows = [replay_call(f"{path}_bf16", name, inp) for name, inp in res["recorded"]
            if not _f32_launch(name, inp)]
    rows += [replay_call(f"{path}_bf16" if name in BACKWARD else f"{path}_bf16_train", name, inp)
             for name, inp in res["trained"] if not _f32_launch(name, inp)]
    errs = [check_scatter_mean_grad(inp) for name, inp in res["recorded"]
            if name in ("scatter_mean_kernel", "windowed_scatter_mean_kernel")]
    if errs:
        log(f"[8 {path}] bf16 scatter-mean backward at {len(errs)} recorded launches: "
            f"max_abs_err {max(errs):.3e} against autograd of the plain version")
    return rows


def _f32_launch(name: str, inp: dict) -> bool:
    """Whether a recorded launch ran on float32 storage (the coordinates'
    gathers, the feature kNN after its upcast, FPS)."""
    for key in ("points", "grads", "features", "packed"):
        if key in inp:
            return inp[key].dtype != torch.bfloat16
    return True


def summarise_bf16(name: str, rows: list, counts: dict) -> dict:
    """The ``kernels`` line's entry of ``name``'s bf16 launches, tagged
    ``[bf16]``: ``summarise``'s keys, its times the sums over the bf16
    launches of one served request (forward kernels) or one train step
    (backward kernels) of markov_partseg at B = 32 x 2048 in bf16 (in
    ``window_all`` for the windowed kernels), and of every path of
    ``BF16_PATHS`` in ``by_path``."""
    backward = name in BACKWARD
    unit = "train" if backward else "serve"
    main = "partseg_window_all" if name.startswith("windowed_") else "partseg"

    def sums(path):
        mine = [r for r in rows if r["name"] == name and r["path"] == f"{path}_bf16"]
        n = counts[f"{path}_bf16_{unit}"].get(name, 0) // (TRAIN_STEPS if backward else REQUESTS)
        # The recorded request's launches, without the parity request's.
        mine = mine[:n]
        if not mine:
            return None
        bytes_ms = sum(r["bytes_ms"] for r in mine)
        ops_ms = sum(r["ops_ms"] for r in mine)
        libs = [r["library_ms"] for r in mine]
        return {"launches_per_unit": len(mine),
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
                "bound_ms": sum(r["bound_ms"] for r in mine),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None if None in libs else sum(libs)}

    by_path = {path: sums(path) for path in BF16_PATHS}
    from mpa_tpu_torch.kernels import SOURCES

    source, replaces = SOURCES[name], REPLACES[name]
    return {"name": f"{name}[bf16]", "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[f"{main}_bf16_{unit}"][name],
            "per": "train step" if backward else "request", "path": f"{main}_bf16",
            "launches_by_path": {run: c.get(name, 0) for run, c in counts.items()},
            **by_path[main], "by_path": by_path}


def f32_window_steps(path: str, tag: str) -> tuple:
    """The float32 train step of a part-seg window mode (``WINDOW_PATHS``),
    two warm-up and ``TRAIN_STEPS`` timed steps, its launch counts exact and
    its losses finite: the step medians beside the bf16 ones of phase 8.
    Returns the step ms and the replays of one more step's backward
    launches (tagged ``PATH_f32``), the float32 times beside bf16's."""
    run = timed_steps(path, fresh_model(path))
    times, losses, launches = run["times"], run["losses"], run["launches"][0]
    log(f"[{tag}] train steps ms {[round(t * 1e3, 3) for t in times]}, losses "
        f"{[round(v, 4) for v in losses]}; launches over {TRAIN_STEPS} steps {launches}")
    check_launches(tag, launches, path_spec(path)["per_train_step"], TRAIN_STEPS, "train step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] non-finite train losses {losses}")
    rows = [replay_call(f"{path}_f32", name, inp) for name, inp in run["recorded"]
            if name in BACKWARD]
    return [t * 1e3 for t in times], rows


def phase8() -> tuple:
    """Phase 8 (module doc): each path's readings, its bf16 launch counts by
    run, and the replays' rows; for the window modes also the float32
    step's times (``f32_step_ms``) and its backward launches' replays."""
    results, rows, counts, f32_rows = {}, [], {}, []
    for path in BF16_PATHS:
        res = bf16_phase(path, f"8 {path} bf16")
        rows += bf16_replay(path, res)
        del res["recorded"], res["trained"]
        counts[f"{path}_bf16_serve"] = res["launches_bf16"]
        counts[f"{path}_bf16_train"] = res["train_launches_bf16"]
        torch.cuda.empty_cache()
        if path in WINDOW_PATHS:
            res["f32_step_ms"], replays = f32_window_steps(path, f"8 {path} f32")
            f32_rows += replays
            torch.cuda.empty_cache()
        results[path] = res
    return results, rows, counts, f32_rows


# Phase 9's exported paths: (the serving path, its loader's keyword arguments).
EXPORT_PATHS = {
    "cls": ("cls", {}),
    "partseg": ("partseg", {}),
    "partseg_window_all": ("partseg_window_all", {}),
    "repsurf": ("repsurf", {}),
    "cls_bf16": ("cls", {"compute_dtype": torch.bfloat16}),
}
EXPORT_TIMED = 10  # timed requests of each program, eager and exported, after two warm-ups
FORWARD = ("knn_kernel", "fps_kernel", "gather_rows_kernel", "transition_attention_fwd_kernel",
           "scatter_mean_kernel", "windowed_knn_kernel", "windowed_attention_fwd_kernel",
           "windowed_scatter_mean_kernel", "ball_query_kernel")


def model_inputs(path: str, request: tuple):
    """A request of ``path`` as its model takes it, on the card: the
    points, or ``(points, category one-hot)`` for part-seg."""
    x = torch.from_numpy(request[0]).cuda()
    if not path.startswith("partseg"):
        return x
    onehot = torch.nn.functional.one_hot(torch.from_numpy(request[1]).long().cuda(), 16)
    return x, onehot.float()


def timed_program(fn, inputs: list) -> dict:
    """Two warm-up calls of ``fn`` on ``inputs[0]``, then ``EXPORT_TIMED``
    timed ones cycling through ``inputs[1:]``: their ms, each request's
    launch counts (all, and bf16), and the answers of the first pass."""
    from mpa_tpu_torch import kernels

    for _ in range(2):
        fn(inputs[0])
    torch.cuda.synchronize()
    ms, launches, answers = [], [], []
    for i in range(EXPORT_TIMED):
        x = inputs[1 + i % (len(inputs) - 1)]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append((dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BF16)))
        if i < len(inputs) - 1:
            answers.append(out)
    return {"ms": ms, "launches": launches, "answers": answers}


def exported_child(work: Path) -> None:
    """Phase 9's child process: load every artifact listed in
    ``work/programs.json`` with ``mpa_tpu_torch.serve.load_inference`` (no
    model code imported), answer its requests as :func:`timed_program`
    does, hold the answers against the eager ones saved beside it, and write
    the readings to ``work/child.json``."""
    import mpa_tpu_torch.ops  # noqa: F401  (registers the mpa:: ops)
    from mpa_tpu_torch.serve import load_inference

    out = {}
    for name in json.loads((work / "programs.json").read_text()):
        saved = torch.load(work / f"{name}.io.pt", weights_only=True)
        inputs = [tuple(t.cuda() for t in x) if isinstance(x, (list, tuple)) else x.cuda()
                  for x in saved["inputs"]]
        t0 = time.perf_counter()
        infer = load_inference(str(work / f"{name}.pt2"))
        load_s = time.perf_counter() - t0
        run = timed_program(infer, inputs)
        pairs = [(got.cpu(), want) for got, want in zip(run["answers"], saved["answers"])]
        diffs = [(got.float() - want.float()).abs().max().item() for got, want in pairs]
        equal = [torch.equal(got, want) for got, want in pairs]
        out[name] = {"load_s": load_s, "ms": run["ms"], "launches": run["launches"],
                     "equal": equal, "max_abs": diffs}
    out["imports_models"] = "mpa_tpu_torch.models" in sys.modules
    (work / "child.json").write_text(json.dumps(out))


def export_program(name: str, model: torch.nn.Module, inputs: list, work: Path,
                   manifest: dict) -> dict:
    """Export ``model`` on ``inputs[0]``, save it to ``work/NAME.pt2`` and
    answer ``inputs`` eagerly (:func:`timed_program`), saving the inputs and
    answers for the child; returns the export's readings and the eager
    run's."""
    from mpa_tpu_torch.serve import export_inference, save_exported
    from mpa_tpu_torch.serve.export import custom_ops

    t0 = time.perf_counter()
    ep = export_inference(model, inputs[0])
    export_s = time.perf_counter() - t0
    path = work / f"{name}.pt2"
    save_exported(ep, str(path), manifest=manifest)
    with torch.inference_mode():
        eager = timed_program(model, inputs)
    torch.save({"inputs": [tuple(t.cpu() for t in x) if isinstance(x, tuple) else x.cpu()
                           for x in inputs],
                "answers": [a.cpu() for a in eager["answers"]]}, work / f"{name}.io.pt")
    return {"export_s": export_s, "nodes": len(ep.graph.nodes), "ops": custom_ops(ep),
            "bytes": path.stat().st_size, "eager": eager}


def phase9(tag: str, work: Path, cls_checkpoint: str) -> dict:
    """Phase 9: each of ``EXPORT_PATHS`` at its path's batch and width,
    exported (``serve.export_inference``) from the serving loader's model,
    saved, and answered eagerly; ``python -m mpa_tpu_torch.cli.export`` on
    phase 5's ``modelnet40_cls`` checkpoint, answered by the eager model
    restored from it; then one child process loads every artifact, with no
    model code, and answers the same requests: bit for bit the eager
    answers, each request's launches of each kernel exactly the eager
    request's, and the nine forward kernels launched among them. Returns
    each program's readings."""
    from mpa_tpu_torch.cli import eval as cli_eval
    from mpa_tpu_torch.configs import PRESETS
    from mpa_tpu_torch.train import BestCheckpointer

    results = {}
    for name, (path, kw) in EXPORT_PATHS.items():
        model = serve_loader(path, **kw).model
        inputs = [model_inputs(path, r) for r in request_inputs(path)]
        manifest = {"path": path, "seed": SEED, **{k: str(v) for k, v in kw.items()}}
        results[name] = export_program(name, model, inputs, work, manifest)
        del model, inputs
        torch.cuda.empty_cache()

    # cli.export on phase 5's checkpoint, and the eager model restored from it.
    spec = PATHS["cls"]
    out = work / "cli_cls.pt2"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mpa_tpu_torch.cli.export", "--preset",
                           RECIPE["cls"]["preset"], "--checkpoint", cls_checkpoint,
                           "--serve_batch", str(spec["batch"]), "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] cli.export failed:\n{proc.stdout}\n{proc.stderr}")
    log(f"[{tag}] cli.export ({cli_s:.1f} s with its start): {proc.stdout.strip()}")
    state = cli_eval.eval_state(PRESETS[RECIPE["cls"]["preset"]], torch.device("cuda"))
    if BestCheckpointer(cls_checkpoint).restore(state, restore_optimizer=False) is None:
        raise AssertionError(f"[{tag}] no checkpoint under {cls_checkpoint}")
    inputs = [model_inputs("cls", r) for r in request_inputs("cls")]
    with torch.inference_mode():
        eager = timed_program(state.model, inputs)
    torch.save({"inputs": [x.cpu() for x in inputs],
                "answers": [a.cpu() for a in eager["answers"]]}, work / "cli_cls.io.pt")
    manifest = json.loads((work / "cli_cls.pt2.json").read_text())
    results["cli_cls"] = {"export_s": cli_s, "nodes": manifest["graph_nodes"],
                          "ops": manifest["custom_ops"], "bytes": out.stat().st_size,
                          "eager": eager}
    del state, inputs
    torch.cuda.empty_cache()

    # One child process loads every artifact and answers the same requests.
    (work / "programs.json").write_text(json.dumps(list(results)))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--exported-child",
                           str(work)], cwd=REPO, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] the child failed:\n{proc.stdout}\n{proc.stderr}")
    child = json.loads((work / "child.json").read_text())
    log(f"[{tag}] child process ({time.perf_counter() - t0:.1f} s with its start) imported "
        f"mpa_tpu_torch.models: {child['imports_models']}")
    if child["imports_models"]:
        raise AssertionError(f"[{tag}] loading the artifacts imported the model code")
    launched = set()
    for name, r in results.items():
        c = child[name]
        eager_launches = r["eager"]["launches"]
        launched |= {k for lc, _ in c["launches"] for k, v in lc.items() if v}
        eager_ms, exported_ms = statistics.median(r["eager"]["ms"]), statistics.median(c["ms"])
        log(f"[{tag} {name}] export {r['export_s']:.2f} s, {r['nodes']} graph nodes, "
            f"{r['bytes']} bytes, ops {r['ops']}; loaded in {c['load_s']:.2f} s; request median "
            f"ms exported {exported_ms:.3f} against eager {eager_ms:.3f} (exported {c['ms']}, "
            f"eager {r['eager']['ms']}); answers bit-equal {c['equal']}, max |d| {c['max_abs']}; "
            f"launches a request {c['launches'][0][0]} (bf16 {c['launches'][0][1]})")
        if not all(c["equal"]):
            raise AssertionError(f"[{tag} {name}] exported answers differ from eager: "
                                 f"max |d| {c['max_abs']}")
        if [tuple(x) for x in c["launches"]] != [tuple(x) for x in eager_launches]:
            raise AssertionError(f"[{tag} {name}] exported launches {c['launches']} against "
                                 f"eager {eager_launches}")
        r.update(exported_ms=c["ms"], load_s=c["load_s"])
        del r["eager"]["answers"]
    if launched != set(FORWARD):
        raise AssertionError(f"[{tag}] the exported programs launched {sorted(launched)}, "
                             f"want the nine forward kernels {sorted(FORWARD)}")
    return results


# -- phase 10: DGCNN and the extras' kernel users -------------------------------------


def busy_share(fn, n: int = 3) -> tuple:
    """``n`` calls of ``fn`` (each ending in a synchronise) under
    ``torch.profiler``: the mean host ms a call and the device's busy share
    of it (the union of its kernels' intervals over the wall time)."""
    from mpa_tpu_torch.utils.profiling import device_events

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device_events(prof)):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return wall * 1e3 / n, busy / 1e6 / wall


def dgcnn_parity(batch: int = DGCNN_PATH["parity_batch"]) -> dict:
    """The DGCNN served on the card against the CPU (plain ops) from the
    same weights on ``batch`` request clouds: the largest logit difference,
    the share of clouds whose argmax agrees, the CPU's seconds and every
    launch of the card request (``recorded``)."""
    from mpa_tpu_torch import kernels

    x = request_inputs("dgcnn")[1][0][:batch]
    kernels.recorded = []
    try:
        got = serve_loader("dgcnn")(x).cpu()
    finally:
        recorded, kernels.recorded = kernels.recorded, None
    cpu = serve_loader("dgcnn", device="cpu")
    t0 = time.perf_counter()
    want = cpu(x)
    return {"max_abs": (got - want).abs().max().item(),
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1)).float().mean().item(),
            "cpu_s": time.perf_counter() - t0, "recorded": recorded}


def dgcnn_served(tag: str) -> tuple:
    """Phase 10a: the DGCNN's requests, launches, answers, busy share, the
    card against the CPU, and every launch of a request replayed."""
    spec = DGCNN_PATH
    B, points = spec["batch"], spec["points"]
    serve = serve_loader("dgcnn")
    latencies, outputs, (launches, _), recorded = timed_requests(serve, "dgcnn")
    for i, lat in enumerate(latencies):
        log(f"[{tag}] request {i}: B={B} x {points} pts, {lat * 1e3:.3f} ms, "
            f"{B / lat:.1f} clouds/s")
    log(f"[{tag}] launches over {REQUESTS} requests: {launches}")
    check_launches(tag, launches, spec["per_forward"], REQUESTS, "request")
    for out in outputs:
        check_served_output("dgcnn", out, B, points)
    x = request_inputs("dgcnn")[1][0]
    wall, busy = busy_share(lambda: (serve(x), torch.cuda.synchronize()))
    log(f"[{tag}] median request {statistics.median(latencies) * 1e3:.3f} ms; under the "
        f"profiler {wall:.3f} ms a request, device busy {100 * busy:.1f}%")
    report = dgcnn_parity()
    log(f"[{tag}] cuda vs cpu at B={spec['parity_batch']} x {points} pts (plain ops, "
        f"{report['cpu_s']:.1f} s on the host): max |dlogit| {report['max_abs']:.3e}, argmax "
        f"agreement {report['argmax_agreement']:.4f} (limits {DGCNN_LIMITS})")
    if not within(report, DGCNN_LIMITS):
        raise AssertionError(f"[{tag}] cuda and cpu logits differ: {report}")
    del serve
    return {"launches": launches, "recorded": recorded, "busy": busy,
            "latency_ms": [t * 1e3 for t in latencies]}


def dgcnn_trained(tag: str) -> dict:
    """Phase 10b: the DGCNN's train step on the card (five timed, their
    launches and busy share), ten steps on one batch, and one step at B = 4
    against the CPU's."""
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import create_train_state

    spec, cfg = DGCNN_PATH, path_config("dgcnn")
    B = spec["batch"]
    run = timed_steps("dgcnn", fresh_model("dgcnn"))
    log(f"[{tag}] step ms {[round(t * 1e3, 3) for t in run['times']]}, losses "
        f"{[round(v, 4) for v in run['losses']]}, launches over {TRAIN_STEPS} steps "
        f"{run['launches'][0]}; peak memory {run['peak'] / 2**30:.3f} GiB")
    check_launches(tag, run["launches"][0], spec["per_train_step"], TRAIN_STEPS, "train step")
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"[{tag}] non-finite train losses {run['losses']}")
    arrays = train_arrays("dgcnn", cfg)
    step = make_step("dgcnn", len(arrays[0]) // B)
    x, y = cli_train.make_inputs(cfg, tuple(a[:B] for a in arrays), torch.device("cuda"))
    wall, busy = busy_share(lambda: float(step(run["state"], x, y)))
    log(f"[{tag}] under the profiler {wall:.3f} ms a step, device busy {100 * busy:.1f}%")
    del run["state"]
    state = create_train_state(fresh_model("dgcnn"), cfg, torch.device("cuda"))
    fixed = [float(step(state, x, y)) for _ in range(FIXED_STEPS)]
    log(f"[{tag}] {FIXED_STEPS} steps on one batch: loss {fixed[0]:.4f} -> {fixed[-1]:.4f} "
        "(the cls loss read on logits, as mpa_tpu trains dgcnn)")
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"[{tag}] the loss did not fall on a fixed batch: {fixed}")
    del state
    parity = train_parity("dgcnn")
    log(f"[{tag}] cuda vs cpu, one step at B={spec['parity_batch']} ({parity['cpu_s']:.1f} s "
        f"on the host): loss |d| {parity['loss_diff']:.3e} (limit {spec['loss_limit']}); "
        f"gradient error in "
        f"units (limit {spec['grad_limit']}), largest: "
        + ", ".join(f"{n} {u:.3f}" for n, u in parity["grad_units"][:3])
        + f"; worst statistic {parity['stat'][0]} rel {parity['stat'][1]:.3e} (limit "
          f"{spec['stat_limit']}); launches {parity['launches']}")
    if (not parity["loss_diff"] <= spec["loss_limit"]
            or parity["grad_units"][0][1] > spec["grad_limit"]
            or parity["stat"][1] > spec["stat_limit"] or parity["launches"] != spec["per_train_step"]):
        raise AssertionError(f"[{tag}] the CUDA train step differs from the CPU step")
    return {"launches": run["launches"][0], "recorded": run["recorded"], "busy": busy,
            "step_ms": [t * 1e3 for t in run["times"]]}


def dgcnn_clis(tag: str, work: Path) -> dict:
    """Phase 10c: ``cli.train --model dgcnn`` three steps on synthetic clouds
    with its eval, ``cli.eval`` of its checkpoint, ``cli.export`` of it, and
    the artifact loaded in phase 9's child process (no model code) against
    the restored eager model: bit-equal answers, the same launches."""
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.cli import eval as cli_eval
    from mpa_tpu_torch.cli import train as cli_train
    from mpa_tpu_torch.train import BestCheckpointer

    spec = DGCNN_PATH
    args = ["--preset", spec["preset"], "--dataset", "synthetic", "--device", "cuda",
            "--log_dir", str(work / "runs"), "--seed", str(SEED), *spec["cli"]]
    kernels.reset_launch_counts()
    _, out = cli_train.run(cli_train.parse_args(args + ["--max_steps", str(RECIPE_STEPS)]))
    torch.cuda.synchronize()
    train_launches = dict(kernels.LAUNCHES)
    cfg = cli_train.config_from_args(cli_train.parse_args(args))
    batches = -(-cli_train.DATASET_SIZES["cls"][1] // cfg.batch_size)
    want = {k: RECIPE_STEPS * spec["per_train_step"].get(k, 0)
            + cfg.num_votes * batches * spec["per_forward"].get(k, 0) for k in kernels.KERNELS}
    log(f"[{tag}] cli.train --model dgcnn: {out['steps']} steps, losses {out['losses']}, eval "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items() if isinstance(v, float))
        + f"; launches {train_launches}")
    check_launches(f"{tag} train", train_launches, want, 1, "run")
    if out["steps"] != RECIPE_STEPS or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"[{tag}] cli.train: {out}")
    ckpt = cli_train.checkpoint_dir(cfg, spec["preset"])

    kernels.reset_launch_counts()
    res = cli_eval.main(args + ["--checkpoint", ckpt, "--num_votes", str(RECIPE_VOTES)])
    launches = dict(kernels.LAUNCHES)
    log(f"[{tag}] cli.eval --checkpoint: " + ", ".join(
        f"{k} {v:.4f}" for k, v in res.items() if isinstance(v, float)) + f"; launches {launches}")
    check_launches(f"{tag} eval", launches, spec["per_forward"],
                   len(res["pass_seconds"]) * RECIPE_VOTES * batches, "forward")
    if not all(0.0 <= v <= 1.0 for v in res.values() if isinstance(v, float)):
        raise AssertionError(f"[{tag}] eval metrics {res}")

    export = work / "export"
    export.mkdir()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mpa_tpu_torch.cli.export", *args[:6],
                           *spec["cli"], "--checkpoint", ckpt, "--serve_batch",
                           str(spec["batch"]), "--out", str(export / "cli_dgcnn.pt2")],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] cli.export failed:\n{proc.stdout}\n{proc.stderr}")
    log(f"[{tag}] cli.export ({cli_s:.1f} s with its start): {proc.stdout.strip()}")
    state = cli_eval.eval_state(cfg, torch.device("cuda"))
    if BestCheckpointer(ckpt).restore(state, restore_optimizer=False) is None:
        raise AssertionError(f"[{tag}] no checkpoint under {ckpt}")
    inputs = [model_inputs("dgcnn", r) for r in request_inputs("dgcnn")]
    with torch.inference_mode():
        eager = timed_program(state.model, inputs)
    torch.save({"inputs": [x.cpu() for x in inputs],
                "answers": [a.cpu() for a in eager["answers"]]}, export / "cli_dgcnn.io.pt")
    (export / "programs.json").write_text(json.dumps(["cli_dgcnn"]))
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--exported-child",
                           str(export)], cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] the child failed:\n{proc.stdout}\n{proc.stderr}")
    child = json.loads((export / "child.json").read_text())
    c = child["cli_dgcnn"]
    manifest = json.loads((export / "cli_dgcnn.pt2.json").read_text())
    log(f"[{tag}] exported: {manifest['graph_nodes']} graph nodes, ops "
        f"{manifest['custom_ops']}; loaded in {c['load_s']:.2f} s in a child that imported "
        f"mpa_tpu_torch.models: {child['imports_models']}; request median ms exported "
        f"{statistics.median(c['ms']):.3f} against eager {statistics.median(eager['ms']):.3f}; "
        f"answers bit-equal {c['equal']}; launches a request {c['launches'][0][0]}")
    if child["imports_models"]:
        raise AssertionError(f"[{tag}] loading the artifact imported the model code")
    if not all(c["equal"]):
        raise AssertionError(f"[{tag}] exported answers differ from eager: {c['max_abs']}")
    if [tuple(x) for x in c["launches"]] != [tuple(x) for x in eager["launches"]]:
        raise AssertionError(f"[{tag}] exported launches {c['launches']} against eager "
                             f"{eager['launches']}")
    return {"train": train_launches, "eval": launches,
            "exported_ms": c["ms"], "eager_ms": eager["ms"]}


def recorded_run(fn):
    """``fn()`` with every launch recorded and counted: ``(result, launches,
    recorded)``."""
    from mpa_tpu_torch import kernels

    kernels.reset_launch_counts()
    kernels.recorded = []
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        recorded, kernels.recorded = kernels.recorded, None
    return out, {k: v for k, v in kernels.LAUNCHES.items() if v}, recorded


def offpath_phase(tag: str) -> tuple:
    """Phase 10d: the extras' and the off-path functions' kernel users on a
    batch of 1024-point clouds, each on the card against the CPU (the
    largest difference over the largest entry within
    ``OFFPATH_REL_LIMIT``), its launches counted and every one replayed:
    ``Disp3DEncoder`` at its defaults (widths 32/64/128, k = 16),
    ``knn_surface_features`` (k = 3), ``inner_correlation`` of gathered rows,
    and a train-mode forward of ``MarkovClassifier(use_umbrella=True,
    umbrella_k=5)`` (the umbrella runs in train mode only, and its output
    is unused: its answer is its BatchNorm's running statistics), with fixed
    normal flips and dropout 0."""
    from mpa_tpu_torch.extras import Disp3DEncoder
    from mpa_tpu_torch.geometry import knn_surface_features
    from mpa_tpu_torch.models import MarkovClassifier
    from mpa_tpu_torch.ops import inner_correlation
    from mpa_tpu_torch.utils.init import init_like_flax

    gen = torch.Generator().manual_seed(SEED)
    pts = torch.randn((8, 1024, 3), generator=gen)
    feats = torch.randn((8, 1024, 64), generator=gen)
    index = torch.randint(0, 1024, (8, 256), generator=gen, dtype=torch.int32)
    enc = init_like_flax(Disp3DEncoder(), torch.Generator().manual_seed(SEED)).eval()
    cls = init_like_flax(MarkovClassifier(use_umbrella=True, umbrella_k=5, dropout=0.0),
                         torch.Generator().manual_seed(SEED)).train()
    flips = torch.tensor([1.0 - 2.0 * (i % 2) for i in range(8)])

    def umbrella_stats(m, d):
        m(pts.to(d), flips=flips.to(d))
        sc = m.surface_constructor
        return torch.cat([sc.bn0.running_mean, sc.bn0.running_var, sc.bn1.running_mean,
                          sc.bn1.running_var])

    cases = {
        "disp3d": (enc, lambda m, d: m(pts.to(d))),
        "knn_surface_features": (None, lambda m, d: torch.cat(knn_surface_features(
            pts.to(d), pts.to(d), k=3, return_dist=True), -1)),
        "inner_correlation": (None, lambda m, d: inner_correlation(feats.to(d), index.to(d))),
        "umbrella_k5": (cls, umbrella_stats),
    }
    rows, counts = [], {}
    for name, (model, fn) in cases.items():
        card = copy.deepcopy(model).cuda() if model is not None else None
        with torch.no_grad():
            got, launches, recorded = recorded_run(lambda: fn(card, "cuda"))
            want = fn(copy.deepcopy(model), "cpu")
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        log(f"[{tag} {name}] output {tuple(got.shape)}: cuda vs cpu max |d| / max |ref| "
            f"{err:.3e} (limit {OFFPATH_REL_LIMIT}); launches {launches}")
        if not err <= OFFPATH_REL_LIMIT:
            raise AssertionError(f"[{tag} {name}] cuda and cpu differ: {err}")
        if name == "umbrella_k5" and not any(n == "knn_kernel" and inp["k"] == 5
                                             for n, inp in recorded):
            raise AssertionError(f"[{tag}] the umbrella's kNN at k = 5 was not launched")
        counts[name] = launches
        rows += [replay_call(f"offpath_{name}", n, inp) for n, inp in recorded]
        del card
    return counts, rows


def phase10(work: Path) -> dict:
    """Phase 10: the DGCNN served, trained and through its CLIs, every
    launch of a request and of a step's backward replayed; then the
    extras' other kernel users (``offpath_phase``)."""
    served = dgcnn_served("10a dgcnn served")
    rows = replay("dgcnn", served, {"recorded": []})
    del served["recorded"]
    torch.cuda.empty_cache()
    trained = dgcnn_trained("10b dgcnn trained")
    rows += [replay_call("dgcnn" if name in BACKWARD else "dgcnn_train", name, inp)
             for name, inp in trained.pop("recorded")]
    torch.cuda.empty_cache()
    clis = dgcnn_clis("10c dgcnn clis", work)
    torch.cuda.empty_cache()
    offpath, off_rows = offpath_phase("10d offpath")
    torch.cuda.empty_cache()
    return {"served": served, "trained": trained, "clis": clis, "offpath": offpath,
            "rows": rows, "offpath_rows": off_rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parity", nargs="?", const="partseg",
                    choices=["partseg", "semseg", "repsurf", "partseg_fp", "pose", "completion",
                             "dp", "bf16", "dgcnn"],
                    help="only that path's card-against-CPU readings, as JSON")
    ap.add_argument("--exported-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--batch-norm", action="store_true",
                    help="only phase 3b, the fused BatchNorm's rows, after the build")
    ap.add_argument("--planted-faults", nargs="?", const="all",
                    choices=["all", "partseg", "semseg", "repsurf", "dp", "bf16", "dgcnn"],
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
    if args.exported_child:
        exported_child(Path(args.exported_child))
        return 0
    from mpa_tpu_torch import kernels
    from mpa_tpu_torch.kernels import build

    if args.planted_faults:
        log(f"[planted] {card_line()}")
        build.build()  # once, for every copy whose kernel sources are the checkout's
        planted_faults(args.planted_faults)
        return 0
    if args.parity:
        print(json.dumps(parity_readings(args.parity)), flush=True)
        return 0
    if args.batch_norm:
        log(f"[3b] {card_line()}")
        build.build(force=True)
        build.load()
        for line in build.ptxas_log.splitlines():
            if line.startswith("== batch_norm") or "batch_norm" in line:
                log(f"[3b build] {line.strip()}")
        print(json.dumps({"batch_norm": batch_norm_phase("3b batch_norm")}), flush=True)
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
    windowed = {}
    for mode in PARTSEG_WINDOW_FORWARD:
        path = f"partseg_{mode}"
        windowed[mode] = serve_phase(path, f"2o {path} served")
        rows += replay(path, windowed[mode], {"recorded": []})
        del windowed[mode]["recorded"]
    torch.cuda.empty_cache()

    floor = launch_floor()
    log(f"[3 floor] empty_kernel (one block of one thread) in the same CUDA-graph harness: "
        f"{floor:.4f} ms a launch")
    batch_norm = batch_norm_phase("3b batch_norm")
    torch.cuda.empty_cache()

    # -- 5: the recipe, cli.train -> checkpoint -> cli.eval, on data trees -------
    recipe_work = tempfile.TemporaryDirectory()  # kept for phase 9's cli.export
    recipe = {path: recipe_phase(path, f"5 {path} recipe", Path(recipe_work.name))
              for path in RECIPE}
    torch.cuda.empty_cache()

    # -- 6: S3DIS rooms through cli.train and the sliding scene inference ------------
    with tempfile.TemporaryDirectory() as work:
        scene = s3dis_phase("6 s3dis", Path(work))
    rows += scene.pop("rows")
    torch.cuda.empty_cache()

    # -- 7: data parallelism, the trainer's flags, reference weights, keyed FPS ---
    with tempfile.TemporaryDirectory() as work:
        dp_counts, dp_rows = phase7(Path(work))
    rows += dp_rows
    torch.cuda.empty_cache()

    # -- 8: mixed precision, bf16 cls and part-seg served, trained, replayed --------
    bf16, bf16_rows, bf16_counts, f32_window_rows = phase8()
    rows += f32_window_rows
    torch.cuda.empty_cache()

    # -- 9: inference export, the artifacts loaded in a child process ---------------
    with tempfile.TemporaryDirectory() as work:
        exported = phase9("9 export", Path(work), recipe["cls"]["checkpoint"])
    recipe_work.cleanup()
    torch.cuda.empty_cache()

    # -- 10: DGCNN served, trained, its CLIs; the extras' other kernel users --------
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        dgcnn = phase10(Path(work))
    t10 = time.perf_counter() - t10

    counts = {f"{path}_serve": served[path]["launches"] for path in PATHS}
    counts.update({f"{path}_train": trained[path]["launches"] for path in PATHS})
    counts.update({f"{path}_recipe_{run}": recipe[path][run] for path in RECIPE
                   for run in ("train", "eval")})
    counts.update({f"partseg_{mode}_serve": w["launches"] for mode, w in windowed.items()})
    counts.update({f"s3dis_{run}": scene[run] for run in ("train", "scene")})
    counts.update(dp_counts)
    summary = [summarise(name, rows, counts) for name in kernels.KERNELS]
    summary += [summarise_bf16(name, bf16_rows, bf16_counts) for name in kernels.BF16_KERNELS]
    log("[4 kernels] times are per request for the forward kernels and per train step for "
        "the backward kernels: the sum over its launches of each; top level: the kernel's "
        "path, markov_semseg window_all at B=2 x 16384 points for the windowed kernels, "
        "repsurf_ssg_2x at B=64 x 1024 points for the ball query, markov_partseg at "
        "B=32 x 2048 points for the others; by_path.cls and by_path.repsurf: markov_cls and "
        "repsurf_ssg_2x at B=64 x 1024 points; the [bf16] entries: markov_partseg in bf16 at "
        "B=32 x 2048, in window_all for the windowed kernels, and by_path each bf16 path")
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
    log(f"[6 s3dis] ({card}) cli.train epoch seconds {scene['epoch_seconds']}, clouds/s "
        f"{scene['clouds_per_s']}; scene inference {scene['scene_s']:.3f} s "
        f"for {scene['scene_points']} points ({scene['scene_host_s']:.3f} s of it host work); "
        f"card vs cpu label agreement "
        f"{scene['label_agreement']:.5f}")
    for path, r in recipe.items():
        log(f"[5 {path}] recipe ({card}): eval {r['clouds_s']:.1f} clouds/s, train "
            f"epoch seconds {r['epoch_seconds']}, {r['clouds_per_s']} clouds/s")
    for path, r in bf16.items():
        f32_request = (served[path] if path in served
                       else windowed[path_spec(path)["overrides"]["neighbor_mode"]])["latency_ms"]
        f32_step = trained[path]["step_ms"] if path in trained else r["f32_step_ms"]
        med = {k: statistics.median(v) for k, v in
               (("bf16 request", r["latency_ms"]), ("f32 request", f32_request),
                ("bf16 step", r["step_ms"]), ("f32 step", f32_step))}
        log(f"[8 {path}] ({card}) median ms: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
            + f"; bf16 step peak memory {r['peak_bytes'] / 2**30:.3f} GiB; card vs cpu: served "
            f"{r['served']}, step's largest gradient error {r['grad_units']}")
        for row in summary:
            if row["name"].endswith("[bf16]") and row["by_path"].get(path):
                t = row["by_path"][path]
                log(f"[8 {path}] {row['name']} per {row['per']}: {t['launches_per_unit']} "
                    f"launches, {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    for name, r in exported.items():
        log(f"[9 {name}] ({card}) export {r['export_s']:.2f} s, {r['nodes']} graph nodes, "
            f"{r['bytes'] / 2**20:.2f} MiB; request median ms exported "
            f"{statistics.median(r['exported_ms']):.3f}, eager "
            f"{statistics.median(r['eager']['ms']):.3f}")
    lat, step = dgcnn["served"]["latency_ms"], dgcnn["trained"]["step_ms"]
    log(f"[10 dgcnn] ({card}) request ms {lat}, median {statistics.median(lat):.3f} ms "
        f"({DGCNN_PATH['batch'] / statistics.median(lat) * 1e3:.1f} clouds/s), device busy "
        f"{100 * dgcnn['served']['busy']:.1f}%; train step ms {step}, median "
        f"{statistics.median(step):.3f} ms, device busy {100 * dgcnn['trained']['busy']:.1f}%; "
        f"exported request median {statistics.median(dgcnn['clis']['exported_ms']):.3f} ms "
        f"against eager {statistics.median(dgcnn['clis']['eager_ms']):.3f}")
    for name in ("knn_kernel", "gather_rows_kernel", "scatter_add_rows_kernel"):
        for path in ("dgcnn", "dgcnn_train", "dgcnn_knn_grad"):
            mine = [r for r in dgcnn["rows"] if r["name"] == name and r["path"] == path]
            unit = {"dgcnn_train": "step", "dgcnn_knn_grad": "kNN gradient"}.get(
                path, "step" if name in BACKWARD else "request")
            if mine:
                log(f"[10 dgcnn] ({card}) {name} per {unit} ({path}): {len(mine)} launches, "
                    f"{sum(r['ms'] for r in mine):.4f} ms, plain "
                    f"{sum(r['plain_ms'] for r in mine):.4f} ms, bound "
                    f"{sum(r['bound_ms'] for r in mine):.4f} ms, library "
                    + (f"{sum(r['library_ms'] for r in mine):.4f}"
                       if all(r["library_ms"] is not None for r in mine) else "none")
                    + f" ms, max_abs_err {max(r['max_abs_err'] for r in mine):.3e}")
    log(f"[10 offpath] launches {dgcnn['offpath']}; {len(dgcnn['offpath_rows'])} replays agree")
    log(f"[10 total] {t10:.1f} s")
    print(card, flush=True)  # the card, exactly as nvidia-smi reports it
    log(f"[4 total] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": summary, "batch_norm": batch_norm}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
