"""Evaluation metrics, numpy (a copy of ``mpa_tpu/train/metrics.py``'s
protocols): classification instance and class-average accuracy (reference
tool/train_cls_scanobjectnn.py:115-123), and the ShapeNetPart protocol
(reference tool/train_partseg.py:226-290): the argmax restricted to the
shape's category parts, per-shape IoU averaged over that category's part
labels with an absent part counting 1.0, then instance and class mIoU, and
the per-point accuracies of the reference's part-seg eval
(tool/test_partseg.py)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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


def category_masked_argmax(
    logits: np.ndarray,
    category: np.ndarray,
    seg_parts: Sequence[Sequence[int]],
    replicate_offset_quirk: bool = False,
) -> np.ndarray:
    """Argmax restricted to each shape's category part labels.

    logits ``[B, N, P]``, category ``[B]`` int (index into ``seg_parts``).
    Returns global part labels ``[B, N]``. ``replicate_offset_quirk=True``
    reproduces the reference eval script's missing re-offset (category-local
    indices compared with global targets); for golden-number replays only.
    """
    B, N, _ = logits.shape
    out = np.zeros((B, N), dtype=np.int64)
    for b in range(B):
        parts = np.asarray(seg_parts[category[b]])
        local = np.argmax(logits[b][:, parts], axis=-1)
        out[b] = local if replicate_offset_quirk else parts[local]
    return out


def part_iou_metrics(
    preds: List[np.ndarray],
    targets: List[np.ndarray],
    categories: List[int],
    seg_parts: Sequence[Sequence[int]],
) -> Tuple[float, float, Dict[int, float]]:
    """ShapeNetPart IoU protocol over a dataset: per-shape ``[N]`` global
    part labels and the shape's category index ->
    ``(instance_mIoU, class_avg_mIoU, per-category mIoU)``."""
    shape_ious: Dict[int, List[float]] = {c: [] for c in range(len(seg_parts))}
    for pred, target, cat in zip(preds, targets, categories):
        part_ious = []
        for part in seg_parts[cat]:
            p = pred == part
            t = target == part
            union = np.sum(p | t)
            if union == 0:
                part_ious.append(1.0)  # absent part convention
            else:
                part_ious.append(float(np.sum(p & t)) / float(union))
        shape_ious[cat].append(float(np.mean(part_ious)))
    all_shape_ious = [iou for lst in shape_ious.values() for iou in lst]
    instance_miou = float(np.mean(all_shape_ious)) if all_shape_ious else 0.0
    cat_mious = {c: float(np.mean(lst)) for c, lst in shape_ious.items() if lst}
    class_miou = float(np.mean(list(cat_mious.values()))) if cat_mious else 0.0
    return instance_miou, class_miou, cat_mious


def point_accuracy(preds: List[np.ndarray], targets: List[np.ndarray]) -> float:
    """Overall per-point accuracy across shapes."""
    correct = sum(int(np.sum(p == t)) for p, t in zip(preds, targets))
    total = sum(p.size for p in preds)
    return correct / total if total else 0.0


def class_avg_point_accuracy(
    preds: List[np.ndarray],
    targets: List[np.ndarray],
    seg_parts: Sequence[Sequence[int]],
) -> float:
    """The reference's "Class avg accuracy": the mean over global PART labels
    of per-part recall (tool/test_partseg.py:164-167,194-195, accumulated over
    ``num_part`` labels, not per category). Part labels never seen in the
    targets are skipped (the reference would divide by zero there; on the
    full test set every part occurs)."""
    num_parts = max(p for parts in seg_parts for p in parts) + 1
    seen = np.zeros(num_parts, dtype=np.int64)
    correct = np.zeros(num_parts, dtype=np.int64)
    for pred, target in zip(preds, targets):
        for lab in np.unique(target):
            mask = target == lab
            seen[lab] += int(np.sum(mask))
            correct[lab] += int(np.sum(pred[mask] == lab))
    valid = seen > 0
    return float(np.mean(correct[valid] / seen[valid])) if valid.any() else 0.0
