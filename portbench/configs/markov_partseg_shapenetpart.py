"""``markov_partseg`` under the ``shapenetpart`` preset: the program's entries,
the plain reference, the comparison of served answers, and the model's
operations. The sizes are in ``markov_partseg_shapenetpart.json``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench import roofline
from portbench.reference import markov_partseg as ref


def reference(sizes: dict) -> torch.nn.Module:
    return ref.build(sizes)


def reference_forward(model, points: torch.Tensor, extra: Optional[torch.Tensor],
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return model(points, extra, generator)


def request_tensors(request: Dict[str, np.ndarray], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A request's inputs on ``device``: ``(points, category)``."""
    return (torch.from_numpy(request["points"]).to(device),
            torch.from_numpy(request["category"]).to(device))


def train_arrays(data: Dict[str, np.ndarray]) -> tuple:
    """The traffic's arrays in the order the program's trainer batches them."""
    return data["points"], data["category"], data["labels"]


def reference_batch(batch: tuple, device) -> tuple:
    """A host batch of :func:`train_arrays` as the reference takes it:
    ``(points, category, labels)`` on ``device``."""
    pts, cats, labels = batch
    return tuple(torch.from_numpy(a).to(device) for a in (pts, cats, labels))


def serve_program(sizes: dict, seed: int, device):
    """The program's segmenter through its serve entry; returns ``(call,
    model)``: ``call(request)`` answers a request's host arrays with
    log-probs on the card."""
    from mpa_tpu_torch.serve import load_segmenter

    segmenter = load_segmenter(sizes["preset"], device=device, seed=seed,
                               num_points=sizes["num_points"])

    def call(request: Dict[str, np.ndarray]) -> torch.Tensor:
        return segmenter(request["points"], request["category"])

    return call, segmenter.model


def compare_answers(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """Over the request's clouds, from each point's largest gap of a part's
    log-probability: ``logp_max_gap``, the largest gap at any point, so that
    one point answered wrongly decides it; ``logp_far_share``, the largest
    share of a cloud's points, in percent, whose gap passes 1e-3, so that
    small gaps spread over many points decide it too."""
    gap = (got.float() - want.float()).abs().amax(dim=-1)  # [B, N]
    return {"logp_max_gap": float(gap.max()),
            "logp_far_share": float(100.0 * (gap > 1e-3).float().mean(dim=1).max())}


def _unit(rows: int, cin: int, cout: int) -> int:
    return 2 * rows * cin * cout


def _trans(B: int, S: int, n_src: int, cin: int, c: int, xyz: bool, res: bool) -> int:
    """A transition's products: k and v on the source rows, v on the
    centres too (coordinates), the residual projection, the ffn."""
    centre = _unit(B * S, cin, c) * (int(xyz) + int(res))
    return 2 * _unit(B * n_src, cin, c) + centre + _unit(B * S, c, c)


def count_ops(sizes: dict, batch: int, points: int) -> Dict[str, int]:
    """The operations of one forward over ``batch`` clouds of ``points``:
    every matrix product at ``2 m n k`` as the model defines it (the
    reference's form), every kNN and transition attention as
    ``roofline.bound`` counts them."""
    B, K = batch, sizes["num_neighbors"]
    ch = sizes["channels"]
    n = [points] + list(sizes["npoints"])
    top = len(sizes["npoints"])
    res = sizes["residuals"]
    mm = knn = attn = 0

    def search(S, N, C):
        return roofline.knn_ops(B, N, S, C)

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
        knn += search(S, n_src, cin)

    def fuse(t):
        nonlocal mm, knn
        for s in range(top + 1):
            if s != t:  # a coarser scale is projected on its own rows, then upsampled
                mm += _unit(B * n[t if s < t else s], ch[s], ch[t])
                if s > t + 1:
                    knn += search(n[s], n[t], 3)
        mm += _unit(B * n[t], ch[t], ch[t])

    knn += search(n[0], n[0], 3)
    state(n[0], n[0], None, ch[0], res[0])
    for i in range(top):
        knn += search(n[i + 1], n[i], 3)
        state(n[i + 1], n[i], ch[i], ch[i + 1], res[i + 1])
    mm += _unit(B * n[top], ch[top], ch[top])
    fuse(top)
    for s in range(top - 1, -1, -1):
        mm += _unit(B * n[s + 1], ch[s + 1], ch[s])
        if s > 0:
            knn += search(n[s], n[s], 3)
        state(n[s], n[s], ch[s], ch[s], False)
        fuse(s)
    width = sizes["point_channels"] + sum(ch) + sizes["label_channels"]
    h = sizes["head"]
    mm += _unit(B, sizes["num_categories"], sizes["label_channels"])
    mm += _unit(B * points, ch[0], sizes["point_channels"])
    mm += _unit(B * points, width, h[0]) + _unit(B * points, h[0], h[1])
    mm += _unit(B * points, h[1], h[2]) + _unit(B * points, h[2], sizes["num_parts"])
    return {"matmul": mm, "knn": knn, "attention": attn, "total": mm + knn + attn}
