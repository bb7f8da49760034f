"""S3DIS semantic segmentation: rooms, block features, block sampling, the
sliding whole-scene inference and the IoU protocol (numpy copies of
``mpa_tpu/data/s3dis.py``, so the same rooms and seed give the same blocks,
in the same order, in both packages).

Rooms are ``Area_{a}_{room}.npy`` files of ``[N, 7]`` rows (xyzrgb and the
label), the standard preprocessed layout; Area 5 is the test split. A
training block is a 1 m x 1 m column of ``num_points`` points with 9
features: xyz centred on the block's column, rgb / 255, and xyz normalised
to the room. Scene inference slides overlapping columns over the whole
room and averages the per-point log-probs of every block a point falls in.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

NUM_CLASSES = 13
CLASS_NAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]


def load_room(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """One room file: ``[N, 7]`` rows -> (xyzrgb ``[N, 6]`` float32, labels
    ``[N]`` int64)."""
    arr = np.load(path)
    return arr[:, :6].astype(np.float32), arr[:, 6].astype(np.int64)


def list_rooms(root: str, test_area: int = 5, split: str = "train") -> List[str]:
    """The sorted ``Area_*.npy`` room files under ``root``: those of every
    area but ``test_area`` for ``split="train"``, that area's for any other
    split (the name must contain ``Area_{test_area}``, as ``mpa_tpu`` tests
    it)."""
    rooms = sorted(f for f in os.listdir(root) if f.endswith(".npy") and "Area_" in f)
    tag = f"Area_{test_area}"
    rooms = [r for r in rooms if (tag not in r) == (split == "train")]
    return [os.path.join(root, r) for r in rooms]


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


def sliding_blocks(
    xyzrgb: np.ndarray,
    num_points: int = 4096,
    block_size: float = 1.0,
    stride: float = 0.5,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Overlapping columns over the whole room, x-major from the room's
    corner at ``stride``. Every point of a column is visited: the column's
    points shuffled (one ``default_rng(0)`` for the room), padded with
    repeats to a multiple of ``num_points``, and cut into blocks. Yields
    (features ``[num_points, 9]``, point indices ``[num_points]``)."""
    room_min, room_max = xyzrgb[:, :3].min(0), xyzrgb[:, :3].max(0)
    xs = np.arange(room_min[0], room_max[0] + 1e-6, stride)
    ys = np.arange(room_min[1], room_max[1] + 1e-6, stride)
    rng = np.random.default_rng(0)
    half = block_size / 2.0
    for cx in xs:
        for cy in ys:
            centre = np.array([cx + half, cy + half])
            mask = (
                (xyzrgb[:, 0] >= centre[0] - half) & (xyzrgb[:, 0] <= centre[0] + half)
                & (xyzrgb[:, 1] >= centre[1] - half) & (xyzrgb[:, 1] <= centre[1] + half)
            )
            idx = np.where(mask)[0]
            if len(idx) == 0:
                continue
            perm = rng.permutation(idx)
            n_chunks = int(np.ceil(len(perm) / num_points))
            pad = n_chunks * num_points - len(perm)
            if pad:
                perm = np.concatenate([perm, rng.choice(idx, pad, replace=True)])
            for k in range(n_chunks):
                choice = perm[k * num_points : (k + 1) * num_points]
                yield block_features(xyzrgb[choice], room_min, room_max, centre), choice


def scene_inference(
    forward: Callable[[np.ndarray], np.ndarray],
    xyzrgb: np.ndarray,
    num_points: int = 4096,
    block_size: float = 1.0,
    stride: float = 0.5,
    batch_size: int = 8,
    num_classes: int = NUM_CLASSES,
) -> np.ndarray:
    """Whole-scene sliding inference: ``forward`` (``[batch_size,
    num_points, 9]`` -> log-probs ``[batch_size, num_points, C]``, anything
    ``np.asarray`` takes) runs on ``sliding_blocks``' blocks in batches of
    ``batch_size``, the last one padded with copies of its last block that
    vote for no point; each point's log-probs are summed over its blocks.
    Returns the per-point argmax ``[N]``; a point no block visited (a
    ``block_size`` / ``stride`` that leave gaps) gets class 0, with a
    warning."""
    votes = np.zeros((len(xyzrgb), num_classes), np.float64)
    counts = np.zeros((len(xyzrgb),), np.int64)
    feats_buf: List[np.ndarray] = []
    idx_buf: List[np.ndarray] = []

    def flush():
        if not feats_buf:
            return
        logp = np.asarray(forward(np.stack(feats_buf)))
        for j, point_idx in enumerate(idx_buf):
            if len(point_idx) == 0:  # a tail-padding copy
                continue
            np.add.at(votes, point_idx, logp[j])
            np.add.at(counts, point_idx, 1)
        feats_buf.clear()
        idx_buf.clear()

    for feats, idx in sliding_blocks(xyzrgb, num_points, block_size, stride):
        feats_buf.append(feats)
        idx_buf.append(idx)
        if len(feats_buf) == batch_size:
            flush()
    if feats_buf:  # the tail batch, padded to batch_size
        while len(feats_buf) < batch_size:
            feats_buf.append(feats_buf[-1])
            idx_buf.append(np.array([], dtype=np.int64))
        flush()
    unvisited = int(np.sum(counts == 0))
    if unvisited:
        warnings.warn(
            f"scene inference left {unvisited}/{len(counts)} points unvisited "
            "(they default to class 0) — check block_size/stride",
            stacklevel=2,
        )
    return votes.argmax(-1)


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
