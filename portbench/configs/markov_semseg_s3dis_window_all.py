"""``markov_semseg`` under the ``s3dis_semseg_window_all`` preset: the program's
entries, the plain reference, the comparison of served answers, and the
model's operations. The sizes are in ``markov_semseg_s3dis_window_all.json``;
the neighbour mode, like every field the benchmark's trainer does not
override (``program.Trainer``: model, seed, batch and points), comes from
the preset."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench import roofline
from portbench.configs import markov_partseg_shapenetpart as partseg
from portbench.reference import markov_semseg as ref
from portbench.reference import window_ops


# The per-point log-probs compare as part-seg's do.
compare_answers = partseg.compare_answers
_unit, _trans = partseg._unit, partseg._trans


def reference(sizes: dict) -> torch.nn.Module:
    return ref.build(sizes)


def reference_forward(model, points: torch.Tensor, extra: Optional[torch.Tensor],
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return model(points, generator)


def request_tensors(request: Dict[str, np.ndarray], device) -> Tuple[torch.Tensor, None]:
    """A request's inputs on ``device``: ``(blocks, None)``."""
    return torch.from_numpy(request["points"]).to(device), None


def train_arrays(data: Dict[str, np.ndarray]) -> tuple:
    """The traffic's arrays in the order the program's trainer batches them."""
    return data["points"], data["labels"]


def reference_batch(batch: tuple, device) -> tuple:
    """A host batch of :func:`train_arrays` as the reference takes it:
    ``(blocks, None, labels)`` on ``device``."""
    pts, labels = batch
    return torch.from_numpy(pts).to(device), None, torch.from_numpy(labels).to(device)


def serve_program(sizes: dict, seed: int, device):
    """The program's semantic segmenter through its serve entry; returns
    ``(call, model)``: ``call(request)`` answers a request's host blocks
    with log-probs on the card."""
    from mpa_tpu_torch.serve import load_semantic_segmenter

    segmenter = load_semantic_segmenter(sizes["preset"], device=device, seed=seed,
                                        num_points=sizes["num_points"])

    def call(request: Dict[str, np.ndarray]) -> torch.Tensor:
        return segmenter(request["points"])

    return call, segmenter.model


def count_ops(sizes: dict, batch: int, points: int) -> Dict[str, int]:
    """The operations of one forward over ``batch`` blocks of ``points``:
    every matrix product at ``2 m n k`` as the model defines it (the
    reference's form), every kNN and transition attention as
    ``roofline.bound`` counts them: a windowed search ``B S window (2C + 3)
    + 2 B (S + N) C + 3 B S k C``, its window from the reference's spec, an
    exact one ``roofline.knn_ops``."""
    B, K = batch, sizes["num_neighbors"]
    ch = sizes["channels"]
    n = [points] + list(sizes["npoints"])
    top = len(sizes["npoints"])
    res = sizes["residuals"]
    windowed = sizes["neighbor_mode"] != "exact"
    banded = sizes["neighbor_mode"] == "window_all"
    mm = knn = attn = 0

    def search(S, N, C, in_window):
        spec = window_ops.window_spec(S, N) if in_window else None
        if spec is None:
            return roofline.knn_ops(B, N, S, C)
        return B * S * spec.window * (2 * C + 3) + 2 * B * (S + N) * C + 3 * B * S * K * C

    def attention(S, c, shift):
        return roofline.attention_ops(B, S, c, K, shift)

    def state(S, n_src, cin, c, residual):
        nonlocal mm, knn, attn
        mm += _trans(B, S, n_src, 3, c, True, True)
        attn += attention(S, c, True)
        if cin is None:
            return
        mm += 2 * _trans(B, S, n_src, cin, c, False, residual) + _unit(B * S, 3 * c, c)
        attn += 2 * attention(S, c, False)
        knn += search(S, n_src, cin, banded)

    def fuse(t):
        nonlocal mm, knn
        for s in range(top + 1):
            if s != t:
                mm += _unit(B * n[t if s < t else s], ch[s], ch[t])
                if s > t + 1:
                    knn += search(n[s], n[t], 3, windowed)
        mm += _unit(B * n[t], ch[t], ch[t])

    knn += search(n[0], n[0], 3, windowed)
    state(n[0], n[0], None, ch[0], res[0])
    mm += _unit(B * n[0], ch[0] + sizes["feature_channels"], ch[0])
    for i in range(top):
        knn += search(n[i + 1], n[i], 3, windowed)
        state(n[i + 1], n[i], ch[i], ch[i + 1], res[i + 1])
    mm += _unit(B * n[top], ch[top], ch[top])
    fuse(top)
    for s in range(top - 1, -1, -1):
        mm += _unit(B * n[s + 1], ch[s + 1], ch[s])
        if s > 0:
            knn += search(n[s], n[s], 3, windowed)
        state(n[s], n[s], ch[s], ch[s], False)
        fuse(s)
    h, width = sizes["head"], sizes["point_channels"] + sum(ch)
    mm += _unit(B * points, ch[0], sizes["point_channels"]) + _unit(B * points, width, h[0])
    mm += _unit(B * points, h[0], h[1]) + _unit(B * points, h[1], sizes["num_classes"])
    return {"matmul": mm, "knn": knn, "attention": attn, "total": mm + knn + attn}
