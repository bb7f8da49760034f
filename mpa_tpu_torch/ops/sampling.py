"""Batch-ingest point subsampling (counterparts of
``mpa_tpu/ops/sampling.py``: ``subsample_points``, ``random_sample``,
``shared_random_sample``), channel-last ``[B, N, C]``.

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


def random_sample(generator: torch.Generator, points: torch.Tensor, num_point: int) -> torch.Tensor:
    """:func:`subsample_points` with ``generator``: an independent uniform
    subset of ``num_point`` points a cloud, without replacement
    (``mpa_tpu/ops/sampling.py::random_sample``)."""
    return subsample_points(points, num_point, generator=generator)


def shared_random_sample(generator: torch.Generator, points: torch.Tensor, num_point: int):
    """One random permutation of the ``N`` points, drawn from ``generator``
    (on the points' device) and shared by every cloud of the batch, cut to
    ``num_point`` (``mpa_tpu/ops/sampling.py::shared_random_sample``).
    Returns ``(sampled [B, num_point, C], idx [B, num_point] int32)``, the
    rows of ``idx`` equal."""
    B, N, _ = points.shape
    if num_point > N:
        raise ValueError(f"cannot draw {num_point} of {N} points without replacement")
    perm = torch.randperm(N, generator=generator, device=points.device)[:num_point]
    return points[:, perm, :], perm.to(torch.int32)[None, :].expand(B, num_point)
