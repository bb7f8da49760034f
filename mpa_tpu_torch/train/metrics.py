"""Classification metrics, numpy (a copy of ``mpa_tpu/train/metrics.py``'s
cls protocol, reference tool/train_cls_scanobjectnn.py:115-123)."""

from __future__ import annotations

import numpy as np


def instance_accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    """Fraction of correct predictions. pred ``[B]`` argmaxed, labels ``[B]``."""
    return float(np.mean(pred == labels))


def class_average_accuracy(pred: np.ndarray, labels: np.ndarray, num_classes: int) -> float:
    """Mean over classes of per-class accuracy (classes absent from
    ``labels`` are skipped)."""
    accs = []
    for c in range(num_classes):
        mask = labels == c
        if np.any(mask):
            accs.append(float(np.mean(pred[mask] == c)))
    return float(np.mean(accs)) if accs else 0.0
