"""Vote test-time augmentation (counterpart of ``mpa_tpu/train/votes.py``).

Reference semantics: the training-time 3-vote eval
(tool/train_cls_scanobjectnn.py:78-124) and the standalone 10-vote eval
(tool/test_classification.py:114-162): vote 0 is the clean cloud, every later
vote scales each cloud's xyz by a per-axis factor in ``[0.95, 1.05)``; the
pool is the mean of the model's log-probs and the prediction its argmax.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def draw_vote_scales(generator: torch.Generator, points: torch.Tensor, low: float = 0.95,
                     high: float = 1.05) -> torch.Tensor:
    """``[B, 1, 3]`` per-cloud, per-axis scales in ``[low, high)``, drawn from
    ``generator`` on the points' device."""
    u = torch.rand((points.shape[0], 1, 3), generator=generator, device=points.device,
                   dtype=points.dtype)
    return low + (high - low) * u


def scale_point_cloud(points: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The xyz channels of cloud b times ``scales[b]`` (``[B, 1, 3]``); later
    channels pass through (reference ``PointcloudScale``,
    tool/test_classification.py:68-79)."""
    xyz = points[..., :3] * scales
    return torch.cat([xyz, points[..., 3:]], dim=-1) if points.shape[-1] > 3 else xyz


def vote_predict(
    forward: Callable[[torch.Tensor], torch.Tensor],
    points: torch.Tensor,
    num_votes: int = 3,
    *,
    generator: Optional[torch.Generator] = None,
    scales: Optional[Sequence[torch.Tensor]] = None,
    low: float = 0.95,
    high: float = 1.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``num_votes`` passes of ``forward``; returns ``(pool, single)``: the
    mean of the passes' log-probs and the clean pass's.

    Vote v >= 1 scales the points by ``scales[v - 1]`` when given, else by
    :func:`draw_vote_scales` from ``generator``.
    """
    if num_votes > 1 and scales is None and generator is None:
        raise ValueError("vote_predict needs a generator or the vote scales")
    if scales is not None and len(scales) != num_votes - 1:
        raise ValueError(f"{len(scales)} vote scales given for {num_votes} votes")
    single = forward(points)
    pool = single
    for v in range(1, num_votes):
        s = scales[v - 1] if scales is not None else draw_vote_scales(generator, points, low, high)
        pool = pool + forward(scale_point_cloud(points, s))
    return pool / num_votes, single
