"""Semantic-segmentation blocks in S3DIS's layout, cut from rooms of labelled
surfaces, all drawn from the seed.

A room is a box of ``4-8 x 3-6 x 2.6-3.2`` m whose points lie on surfaces, as
a scan's do: the floor, the ceiling and four walls, and boxes and planes for
the other S3DIS classes (a beam under the ceiling, a column, a window, a
door and a board on the walls, tables, chairs, a sofa, a bookcase, clutter
on the tables and the floor), 13 labels in S3DIS's order. Points are drawn
uniformly on each surface at about 3000 a square metre, each surface with
a colour of its own and per-point noise on it.

A block is S3DIS's training block (``mpa_tpu_torch/data/s3dis.py``'s
``sample_blocks`` and ``block_features``): a 1 m x 1 m column around the xy
of a random point of a random room, its points drawn with replacement
where the column holds fewer than the block's, and 9 features a point: xyz
centred on the column (z kept), rgb / 255, xyz normalised to the room. Rooms
give blocks with replacement: each block draws its room anew.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

NUM_CLASSES = 13
CEILING, FLOOR, WALL, BEAM, COLUMN, WINDOW, DOOR, TABLE, CHAIR, SOFA, BOOKCASE, BOARD, \
    CLUTTER = range(NUM_CLASSES)
DENSITY = 3000.0  # points a square metre of surface
ROOMS = 8  # rooms a traffic pool draws its blocks from


def _box(rng: np.random.Generator, lo, hi, n: int) -> np.ndarray:
    """``n`` points on the surface of the box ``[lo, hi]``, each face by its
    area."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    size = hi - lo
    areas = np.array([size[1] * size[2], size[0] * size[2], size[0] * size[1]] * 2)
    face = rng.choice(6, size=n, p=areas / areas.sum())
    p = lo + rng.uniform(0.0, 1.0, (n, 3)) * size
    axis = face % 3
    rows = np.arange(n)
    p[rows, axis] = np.where(face < 3, lo[axis], hi[axis])
    return p


def _plane(rng: np.random.Generator, origin, u, v, n: int) -> np.ndarray:
    """``n`` points on the parallelogram ``origin + a u + b v``, a, b in [0, 1)."""
    ab = rng.uniform(0.0, 1.0, (n, 2))
    return np.asarray(origin, float) + ab[:, :1] * np.asarray(u, float) \
        + ab[:, 1:] * np.asarray(v, float)


def _count(area: float) -> int:
    return max(16, int(area * DENSITY))


def _box_area(lo, hi) -> float:
    s = np.asarray(hi, float) - np.asarray(lo, float)
    return 2.0 * (s[0] * s[1] + s[0] * s[2] + s[1] * s[2])


def room(rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """One room: ``(xyzrgb [n, 6] float32, labels [n] int64)``."""
    L, W, H = rng.uniform(4.0, 8.0), rng.uniform(3.0, 6.0), rng.uniform(2.6, 3.2)
    parts: List[Tuple[np.ndarray, int]] = []

    def plane(label, origin, u, v):
        area = float(np.linalg.norm(np.cross(u, v)))
        parts.append((_plane(rng, origin, u, v, _count(area)), label))

    def box(label, lo, hi):
        parts.append((_box(rng, lo, hi, _count(_box_area(lo, hi))), label))

    plane(FLOOR, (0, 0, 0), (L, 0, 0), (0, W, 0))
    plane(CEILING, (0, 0, H), (L, 0, 0), (0, W, 0))
    for origin, u in (((0, 0, 0), (L, 0, 0)), ((0, W, 0), (L, 0, 0)),
                      ((0, 0, 0), (0, W, 0)), ((L, 0, 0), (0, W, 0))):
        plane(WALL, origin, u, (0, 0, H))
    y = rng.uniform(0.5, W - 0.8)
    box(BEAM, (0, y, H - 0.35), (L, y + 0.3, H))
    cx, cy = rng.choice([0.0, L - 0.45]), rng.choice([0.0, W - 0.45])
    box(COLUMN, (cx, cy, 0), (cx + 0.45, cy + 0.45, H))
    x = rng.uniform(0.3, L - 1.6)
    plane(WINDOW, (x, 0.02, 0.9), (1.2, 0, 0), (0, 0, 1.2))
    y = rng.uniform(0.3, W - 1.2)
    plane(DOOR, (0.02, y, 0), (0, 0.9, 0), (0, 0, 2.1))
    x = rng.uniform(0.3, L - 2.0)
    plane(BOARD, (x, W - 0.02, 0.9), (1.6, 0, 0), (0, 0, 1.0))
    by = rng.uniform(0.2, W - 1.2)
    box(BOOKCASE, (L - 0.4, by, 0), (L - 0.02, by + 1.0, 2.0))
    sx, sy = rng.uniform(0.5, L - 2.5), rng.uniform(0.5, W - 1.5)
    box(SOFA, (sx, sy, 0), (sx + 1.8, sy + 0.8, 0.8))
    for _ in range(int(rng.integers(1, 4))):
        tx, ty = rng.uniform(0.5, L - 1.7), rng.uniform(0.5, W - 1.3)
        box(TABLE, (tx, ty, 0.7), (tx + 1.2, ty + 0.8, 0.75))
        for lx, ly in ((tx, ty), (tx + 1.15, ty), (tx, ty + 0.75), (tx + 1.15, ty + 0.75)):
            box(TABLE, (lx, ly, 0), (lx + 0.05, ly + 0.05, 0.7))
        for side in (-1, 1):
            chx = tx + rng.uniform(0.1, 0.7)
            chy = ty - 0.55 if side < 0 else ty + 0.85
            box(CHAIR, (chx, chy, 0.42), (chx + 0.45, chy + 0.45, 0.47))
            back = chy if side < 0 else chy + 0.4
            box(CHAIR, (chx, back, 0.47), (chx + 0.45, back + 0.05, 0.95))
        for _ in range(int(rng.integers(1, 4))):
            ox, oy = tx + rng.uniform(0.0, 1.0), ty + rng.uniform(0.0, 0.6)
            box(CLUTTER, (ox, oy, 0.75), (ox + 0.2, oy + 0.2, 0.75 + rng.uniform(0.05, 0.3)))
    for _ in range(int(rng.integers(2, 6))):
        ox, oy = rng.uniform(0.1, L - 0.5), rng.uniform(0.1, W - 0.5)
        box(CLUTTER, (ox, oy, 0), (ox + rng.uniform(0.1, 0.4), oy + rng.uniform(0.1, 0.4),
                                   rng.uniform(0.1, 0.6)))
    xyz = np.concatenate([p for p, _ in parts])
    labels = np.concatenate([np.full(len(p), c, np.int64) for p, c in parts])
    rgb = np.concatenate([np.clip(rng.uniform(30, 225, 3) + rng.normal(0, 8, (len(p), 3)),
                                  0, 255) for p, _ in parts])
    xyz = xyz + rng.normal(0, 0.003, xyz.shape)  # scanner noise
    return np.concatenate([xyz, rgb], axis=1).astype(np.float32), labels


def block_features(pts: np.ndarray, room_min: np.ndarray, room_max: np.ndarray,
                   centre_xy: np.ndarray) -> np.ndarray:
    """``[n, 6]`` xyzrgb -> ``[n, 9]``: xyz centred on the column (z kept),
    rgb / 255, room-normalised xyz."""
    out = np.zeros((len(pts), 9), np.float32)
    out[:, 0] = pts[:, 0] - centre_xy[0]
    out[:, 1] = pts[:, 1] - centre_xy[1]
    out[:, 2] = pts[:, 2]
    out[:, 3:6] = pts[:, 3:6] / 255.0
    span = np.maximum(room_max - room_min, 1e-6)
    out[:, 6:9] = (pts[:, :3] - room_min) / span
    return out


def blocks(num: int, num_points: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(features [num, num_points, 9] float32, labels [num, num_points]
    int64)``."""
    rng = np.random.default_rng(seed)
    rooms = []
    for _ in range(ROOMS):  # each room's rows by x, so that a column is a slice first
        xyzrgb, lab = room(rng)
        order = np.argsort(xyzrgb[:, 0])
        rooms.append((xyzrgb[order], lab[order]))
    bounds = [(r[:, :3].min(0), r[:, :3].max(0)) for r, _ in rooms]
    feats = np.empty((num, num_points, 9), np.float32)
    labels = np.empty((num, num_points), np.int64)
    b = 0
    while b < num:
        i = int(rng.integers(ROOMS))
        xyzrgb, lab = rooms[i]
        centre = xyzrgb[rng.integers(len(xyzrgb)), :2]
        lo = np.searchsorted(xyzrgb[:, 0], centre[0] - 0.5, side="left")
        hi = np.searchsorted(xyzrgb[:, 0], centre[0] + 0.5, side="right")
        idx = lo + np.flatnonzero(np.abs(xyzrgb[lo:hi, 1] - centre[1]) <= 0.5)
        if len(idx) < 64:  # a nearly empty column: draw again
            continue
        choice = rng.choice(idx, num_points, replace=len(idx) < num_points)
        feats[b] = block_features(xyzrgb[choice], *bounds[i], centre)
        labels[b] = lab[choice]
        b += 1
    return feats, labels


def make(num: int, num_points: int, seed: int, cell: dict) -> Dict[str, np.ndarray]:
    """The traffic of ``num`` blocks: ``points`` ``[num, num_points, 9]``,
    ``labels`` ``[num, num_points]`` over 13 classes."""
    pts, labels = blocks(num, num_points, seed)
    return {"points": pts, "labels": labels}
