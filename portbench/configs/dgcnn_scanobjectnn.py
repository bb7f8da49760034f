"""``dgcnn`` under the ``scanobjectnn_cls`` preset: the program's entries, the
plain reference, the comparison of served answers, and the model's
operations. The sizes are in ``dgcnn_scanobjectnn.json``."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench import roofline
from portbench.reference import dgcnn as ref


def reference(sizes: dict) -> torch.nn.Module:
    return ref.build(sizes)


def reference_forward(model, points: torch.Tensor, extra: Optional[torch.Tensor],
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return model(points, generator)


def request_tensors(request: Dict[str, np.ndarray], device):
    """A request's inputs on ``device``: ``(points, None)``."""
    return torch.from_numpy(request["points"]).to(device), None


def train_arrays(data: Dict[str, np.ndarray]) -> tuple:
    """The traffic's arrays in the order the program's trainer batches them."""
    return data["points"], data["labels"]


def reference_batch(batch: tuple, device) -> tuple:
    """A host batch of :func:`train_arrays` as the reference takes it:
    ``(points, None, labels)`` on ``device``."""
    pts, labels = batch
    return torch.from_numpy(pts).to(device), None, torch.from_numpy(labels).to(device)


def serve_program(sizes: dict, seed: int, device):
    """The program's DGCNN classifier through its serve entry; returns
    ``(call, model)``: ``call(request)`` answers a request's host points
    with logits on the card."""
    from mpa_tpu_torch.serve import load_classifier

    classifier = load_classifier(sizes["preset"], device=device, seed=seed, model=sizes["model"],
                                 num_classes=sizes["num_classes"])

    def call(request: Dict[str, np.ndarray]) -> torch.Tensor:
        return classifier(request["points"])

    return call, classifier.model


def compare_answers(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``logit_gap``: the largest gap of a logit over the request's clouds,
    over the largest logit's magnitude in that cloud (at least 1)."""
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    return {"logit_gap": float(((got.float() - want.float()).abs() / scale).max())}


def count_ops(sizes: dict, batch: int, points: int) -> Dict[str, int]:
    """The operations of one forward over ``batch`` clouds of ``points``:
    every matrix product at ``2 m n k``, every kNN as ``roofline.bound``
    counts it."""
    B, N, k = batch, points, sizes["k"]
    mm = knn = 0
    c = 3
    for w in sizes["block_widths"]:
        knn += roofline.knn_ops(B, N, N, c)
        mm += 2 * B * N * k * 2 * c * w
        c = w
    emb, (h0, h1) = sizes["embedding"], sizes["head"]
    mm += 2 * B * N * sum(sizes["block_widths"]) * emb
    mm += 2 * B * (2 * emb * h0 + h0 * h1 + h1 * sizes["num_classes"])
    return {"matmul": mm, "knn": knn, "total": mm + knn}
