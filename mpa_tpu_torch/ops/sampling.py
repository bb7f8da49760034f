"""Batch-ingest point subsampling (counterpart of
``mpa_tpu/ops/sampling.py::subsample_points``), channel-last ``[B, N, C]``.

The reference's ``sample(num_point, points)`` (tool/train_cls_scanobjectnn.py:22,244)
cuts each batch to ``num_point`` points at ingest: a random subset in
training, a fixed one in eval.
"""

from __future__ import annotations

from typing import Optional

import torch


def subsample_points(points: torch.Tensor, num_point: int, *,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The first ``num_point`` points of each cloud without a generator;
    with one (on the points' device), an independent uniform subset without
    replacement a cloud."""
    B, N, C = points.shape
    if generator is None:
        return points[:, :num_point, :]
    if num_point > N:
        raise ValueError(f"cannot draw {num_point} of {N} points without replacement")
    keys = torch.rand((B, N), generator=generator, device=points.device)
    idx = torch.argsort(keys, dim=-1)[:, :num_point]
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, C))
