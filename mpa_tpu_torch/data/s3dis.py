"""S3DIS semantic segmentation: block features, block sampling and the IoU
protocol (numpy copies of ``mpa_tpu/data/s3dis.py``'s ``block_features``,
``sample_blocks`` and ``semseg_iou``, so the same seed gives the same blocks
in both packages).

Rooms are ``[N, 6]`` xyzrgb with ``[N]`` labels; a training block is a 1 m x
1 m column of ``num_points`` points with 9 features: xyz centred on the
block's column, rgb / 255, and xyz normalised to the room. The room loaders
and the sliding whole-scene inference need the dataset and are not ported
yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NUM_CLASSES = 13
CLASS_NAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]


def block_features(
    pts: np.ndarray, room_min: np.ndarray, room_max: np.ndarray, centre_xy: np.ndarray
) -> np.ndarray:
    """``[n, 6]`` xyzrgb -> ``[n, 9]`` block features (xyz centred on the
    block column, rgb / 255, room-normalised xyz)."""
    out = np.zeros((len(pts), 9), np.float32)
    out[:, 0] = pts[:, 0] - centre_xy[0]
    out[:, 1] = pts[:, 1] - centre_xy[1]
    out[:, 2] = pts[:, 2]
    out[:, 3:6] = pts[:, 3:6] / 255.0
    span = np.maximum(room_max - room_min, 1e-6)
    out[:, 6:9] = (pts[:, :3] - room_min) / span
    return out


def sample_blocks(
    xyzrgb: np.ndarray,
    labels: np.ndarray,
    num_blocks: int,
    num_points: int = 4096,
    block_size: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random column blocks of one room -> (``[num_blocks, num_points, 9]``,
    ``[num_blocks, num_points]``); a block's points are drawn with
    replacement where the column holds fewer than ``num_points``."""
    rng = rng or np.random.default_rng(0)
    room_min, room_max = xyzrgb[:, :3].min(0), xyzrgb[:, :3].max(0)
    out_x = np.zeros((num_blocks, num_points, 9), np.float32)
    out_y = np.zeros((num_blocks, num_points), np.int64)
    b = 0
    attempts = 0
    while b < num_blocks and attempts < num_blocks * 50:
        attempts += 1
        centre = xyzrgb[rng.integers(len(xyzrgb)), :2]
        half = block_size / 2.0
        mask = (
            (xyzrgb[:, 0] >= centre[0] - half) & (xyzrgb[:, 0] <= centre[0] + half)
            & (xyzrgb[:, 1] >= centre[1] - half) & (xyzrgb[:, 1] <= centre[1] + half)
        )
        idx = np.where(mask)[0]
        if len(idx) < 64:  # a nearly empty column: draw again
            continue
        choice = rng.choice(idx, num_points, replace=len(idx) < num_points)
        out_x[b] = block_features(xyzrgb[choice], room_min, room_max, centre)
        out_y[b] = labels[choice]
        b += 1
    return out_x[:b], out_y[:b]


def semseg_iou(
    pred: np.ndarray, target: np.ndarray, num_classes: int = NUM_CLASSES
) -> Tuple[float, float, np.ndarray]:
    """``(mIoU, overall accuracy, per-class IoU)`` over concatenated points;
    a class absent from both prediction and target has IoU NaN and is left
    out of the mean."""
    ious = np.zeros((num_classes,), np.float64)
    for c in range(num_classes):
        inter = np.sum((pred == c) & (target == c))
        union = np.sum((pred == c) | (target == c))
        ious[c] = inter / union if union else np.nan
    miou = float(np.nanmean(ious))
    acc = float(np.mean(pred == target))
    return miou, acc, ious
