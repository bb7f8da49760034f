"""Classification and segmentation losses (counterparts of
``mpa_tpu/train/losses.py``).

``smooth_cls_loss`` is the reference ``SmoothClsLoss``: label-smoothed NLL
over log-probabilities, the off-class mass ``smoothing / (n_class - 1)``;
``cls_loss`` is the plain NLL (``ClsLoss``); ``smooth_seg_loss`` is the same
smoothed NLL over flattened per-point log-probabilities (part-seg
``get_loss``); ``chamfer_distance`` and ``completion_loss`` are the
completion model's objective; ``mi_aux_loss`` is the golden part-seg
snapshot's optional mutual-information auxiliary, wired into no model.
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


def chamfer_distance(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Symmetric squared Chamfer distance between clouds ``[B, N, 3]`` and
    ``[B, M, 3]``: the mean over ``pred``'s points of the squared distance
    to the nearest ``target`` point, plus the same the other way round.
    The ``[B, N, M]`` distances are values here, not a neighbour order: the
    expanded form ``|a|^2 + |b|^2 - 2 a.b`` (one matmul, clamped at 0) in
    the inputs' dtype, at least float32, as ``mpa_tpu`` accumulates them."""
    dtype = torch.promote_types(torch.float32, pred.dtype)
    a, b = pred.to(dtype), target.to(dtype)
    cross = torch.matmul(a, b.transpose(-1, -2))
    d = (a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :] - 2.0 * cross
    d = torch.clamp_min(d, 0.0)
    return torch.mean(torch.amin(d, dim=-1)) + torch.mean(torch.amin(d, dim=-2))


def completion_loss(out, target: torch.Tensor) -> torch.Tensor:
    """The two-stage completion objective: the unweighted sum of the coarse
    and the fine cloud's Chamfer distance to the full cloud; ``out`` is the
    model's ``(coarse, fine)``."""
    coarse, fine = out
    return chamfer_distance(coarse, target) + chamfer_distance(fine, target)


def mi_aux_loss(ret2: torch.Tensor, ret3: torch.Tensor, ret4: torch.Tensor) -> torch.Tensor:
    """The mean over three scales of the mean BCE-with-logits of each
    ``[B, 2M]`` score tensor (M positive-pair scores, then M negative-pair
    ones) against ``[ones(M), zeros(M)]`` (``mpa_tpu/train/losses.py:79``,
    the reference's ``get_loss2``), in float32."""

    def one(ret: torch.Tensor) -> torch.Tensor:
        x = ret.float()
        m = x.shape[1] // 2
        target = torch.cat([torch.ones_like(x[:, :m]), torch.zeros_like(x[:, m:])], dim=1)
        return torch.nn.functional.binary_cross_entropy_with_logits(x, target)

    return (one(ret2) + one(ret3) + one(ret4)) / 3.0
