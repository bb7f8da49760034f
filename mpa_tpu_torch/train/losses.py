"""Classification and segmentation losses (counterparts of
``mpa_tpu/train/losses.py``).

``smooth_cls_loss`` is the reference ``SmoothClsLoss``: label-smoothed NLL
over log-probabilities, the off-class mass ``smoothing / (n_class - 1)``;
``cls_loss`` is the plain NLL (``ClsLoss``); ``smooth_seg_loss`` is the same
smoothed NLL over flattened per-point log-probabilities (part-seg
``get_loss``).
"""

from __future__ import annotations

import torch


def smooth_cls_loss(
    log_probs: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.1
) -> torch.Tensor:
    """Label-smoothed NLL. log_probs ``[B, C]`` (already log-softmaxed),
    labels ``[B]`` int."""
    n_class = log_probs.shape[-1]
    one_hot = torch.zeros_like(log_probs).scatter_(1, labels.long()[:, None], 1.0)
    smoothed = one_hot * (1.0 - smoothing) + (1.0 - one_hot) * smoothing / (n_class - 1)
    return -torch.mean(torch.sum(smoothed * log_probs, dim=-1))


def cls_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain NLL over log-probabilities."""
    return -torch.mean(torch.gather(log_probs, 1, labels.long()[:, None]))


def smooth_seg_loss(
    log_probs: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.1
) -> torch.Tensor:
    """Per-point label-smoothed NLL. log_probs ``[B, N, P]``, labels ``[B, N]``."""
    B, N, P = log_probs.shape
    return smooth_cls_loss(log_probs.reshape(B * N, P), labels.reshape(B * N), smoothing)
