"""Synthetic clouds (numpy copies of ``mpa_tpu/data/synthetic.py``'s
``synthetic_clouds``, ``realistic_clouds``, ``realistic_partseg`` and
``synthetic_partseg``, and of
the synthetic S3DIS rooms of ``mpa_tpu/cli/train.py``, so the same seed gives
the same clouds in both packages)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mpa_tpu_torch.data.s3dis import sample_blocks
from mpa_tpu_torch.data.shapenetpart import SEG_PARTS


def synthetic_clouds(
    num: int, num_points: int = 1024, num_classes: int = 15, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Separable toy classification clouds: class c is a noisy ellipsoid with
    class-dependent axis ratios, learnable in a few steps. Returns
    ``(points [num, num_points, 3] float32, labels [num] int64)``."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, num_classes, size=(num,))
    pts = r.normal(size=(num, num_points, 3)).astype(np.float32)
    scales = 0.5 + np.stack(
        [
            1.0 + (labels % 3),
            1.0 + ((labels // 3) % 3),
            1.0 + ((labels // 9) % 3),
        ],
        axis=-1,
    ).astype(np.float32)
    pts = pts * scales[:, None, :] * 0.2
    return pts, labels.astype(np.int64)


# --- composed-primitive part-seg clouds ---------------------------------------


def _unit_primitive(rng: np.random.Generator, kind: int, n: int) -> np.ndarray:
    """n points on a canonical unit surface primitive; kind in [0, 6)."""
    if kind == 0:  # sphere surface
        p = rng.normal(size=(n, 3))
        return p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-9)
    if kind == 1:  # box surface
        face = rng.integers(0, 6, size=n)
        uv = rng.uniform(-1.0, 1.0, size=(n, 2))
        p = np.empty((n, 3))
        axis, sign = face % 3, np.where(face < 3, 1.0, -1.0)
        for a in range(3):
            m = axis == a
            cols = [c for c in range(3) if c != a]
            p[m, a] = sign[m]
            p[np.ix_(m, cols)] = uv[m]
        return p
    if kind == 2:  # cylinder side
        th = rng.uniform(0, 2 * np.pi, size=n)
        z = rng.uniform(-1.0, 1.0, size=n)
        return np.stack([np.cos(th), np.sin(th), z], axis=-1)
    if kind == 3:  # cone
        z = rng.uniform(0.0, 1.0, size=n)
        th = rng.uniform(0, 2 * np.pi, size=n)
        r = 1.0 - z
        return np.stack([r * np.cos(th), r * np.sin(th), 2 * z - 1], axis=-1)
    if kind == 4:  # torus (R=1, r=0.35)
        u = rng.uniform(0, 2 * np.pi, size=n)
        v = rng.uniform(0, 2 * np.pi, size=n)
        w = 1.0 + 0.35 * np.cos(v)
        return np.stack([w * np.cos(u), w * np.sin(u), 0.35 * np.sin(v)], axis=-1)
    # kind == 5: flat disc
    r = np.sqrt(rng.uniform(0, 1, size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return np.stack([r * np.cos(th), r * np.sin(th), np.zeros(n)], axis=-1)


def _rotation_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _class_spec(class_seed: int, num_prims: int):
    """Fixed-per-class primitive layout: (kind, offset, per-axis scale, rot)."""
    rng = np.random.default_rng(class_seed)
    spec = []
    for _ in range(num_prims):
        kind = int(rng.integers(0, 6))
        offset = rng.uniform(-0.55, 0.55, size=3)
        scale = rng.uniform(0.2, 0.6, size=3)
        rot = _rotation_z(float(rng.uniform(0, 2 * np.pi)))
        spec.append((kind, offset, scale, rot))
    return spec


def _compose_cloud(
    rng: np.random.Generator,
    spec,
    num_points: int,
    weights: Optional[np.ndarray] = None,
    base_rotation: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample a cloud from a class spec; returns (points, per-point prim id).
    Applies a per-cloud random z-rotation (unless ``base_rotation=False``),
    uniform scale, jitter, and the reference's pc_normalize (centre + unit
    max radius)."""
    k = len(spec)
    if weights is None:
        weights = np.full(k, 1.0 / k)
    counts = np.maximum(1, (weights * num_points).astype(int))
    counts[0] += num_points - counts.sum()
    parts, ids = [], []
    for j, ((kind, offset, scale, rot), c) in enumerate(zip(spec, counts)):
        p = _unit_primitive(rng, kind, c) * scale @ rot.T + offset
        parts.append(p)
        ids.append(np.full(c, j, dtype=np.int64))
    pts = np.concatenate(parts, axis=0)
    pid = np.concatenate(ids, axis=0)
    perm = rng.permutation(num_points)
    pts, pid = pts[perm], pid[perm]
    if base_rotation:
        pts = pts @ _rotation_z(float(rng.uniform(0, 2 * np.pi))).T
    else:
        rng.uniform(0, 2 * np.pi)  # keep the stream position identical
    pts = pts * float(rng.uniform(0.9, 1.1))
    pts = pts + rng.normal(scale=0.01, size=pts.shape)
    pts = pts - pts.mean(axis=0, keepdims=True)
    pts = pts / (np.max(np.linalg.norm(pts, axis=-1)) + 1e-9)
    return pts.astype(np.float32), pid


def realistic_partseg(
    num: int,
    num_points: int = 2048,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Composed-primitive part segmentation with the REAL ShapeNetPart label
    layout (16 categories / 50 global parts, ``data/shapenetpart.py`` SEG_PARTS):
    category c's shape is one primitive per part, each labeled with that
    category's global part ids. Returns (points, category, per-point labels)."""
    specs = [_class_spec(2000 + c, len(parts)) for c, parts in enumerate(SEG_PARTS)]
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, len(SEG_PARTS), size=(num,))
    pts = np.empty((num, num_points, 3), dtype=np.float32)
    labels = np.empty((num, num_points), dtype=np.int64)
    for i in range(num):
        c = int(cats[i])
        part_ids = np.asarray(SEG_PARTS[c])
        w = rng.dirichlet(np.full(len(part_ids), 6.0))
        w = 0.05 + 0.95 * w  # every part keeps >=5% of the points
        w = w / w.sum()
        pts[i], pid = _compose_cloud(rng, specs[c], num_points, weights=w)
        labels[i] = part_ids[pid]
    return pts, cats.astype(np.int64), labels


def realistic_clouds(
    num: int,
    num_points: int = 1024,
    num_classes: int = 15,
    seed: int = 0,
    canonical_pose: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Composed-primitive classification clouds: class c is a fixed layout of
    three surface primitives, each cloud drawn on it with a random
    z-rotation (none with ``canonical_pose``, which keeps every cloud in its
    class's frame, as the pose task needs), scale and jitter, centred and
    scaled to unit radius (``_compose_cloud``). Returns ``(points [num,
    num_points, 3] float32, labels [num] int64)``."""
    specs = [_class_spec(1000 + c, 3) for c in range(num_classes)]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(num,))
    pts = np.empty((num, num_points, 3), dtype=np.float32)
    for i, c in enumerate(labels):
        pts[i] = _compose_cloud(rng, specs[c], num_points, base_rotation=not canonical_pose)[0]
    return pts, labels.astype(np.int64)


def surface_clouds(
    num: int, num_points: int = 1024, num_classes: int = 15, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Classification clouds on object surfaces normalised to the unit
    sphere, as ScanObjectNN's scanned objects are: ``realistic_clouds``. A
    small ball around a surface point holds its neighbours on the surface,
    where ``synthetic_clouds``, filled volumes, leave most radius-0.1 balls
    with their centre alone."""
    return realistic_clouds(num, num_points, num_classes, seed)


def synthetic_partseg(
    num: int,
    num_points: int = 2048,
    num_categories: int = 16,
    num_parts: int = 50,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Toy part-seg: each cloud is split into axis-aligned halves whose part
    labels come from the shape's category block — (points, category, labels)."""
    r = np.random.default_rng(seed)
    cats = r.integers(0, num_categories, size=(num,))
    parts_per_cat = max(2, num_parts // num_categories)
    pts = r.uniform(-1, 1, size=(num, num_points, 3)).astype(np.float32)
    labels = np.zeros((num, num_points), dtype=np.int64)
    for i in range(num):
        base = cats[i] * parts_per_cat
        labels[i] = base + (pts[i, :, 2] > 0).astype(np.int64)
    return pts, cats.astype(np.int64), labels


def synthetic_semseg(
    num_rooms: int, num_points: int = 4096, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """S3DIS-style blocks from synthetic rooms (``mpa_tpu/cli/train.py``'s
    ``_semseg_synthetic``): each room is uniform xyzrgb in a 4 x 3 x 2.5 m box,
    labelled by three height bands, with 20000 points up to 4096-point blocks
    and ``5 * num_points`` above (so a block still draws each point about 2.4
    times, as S3DIS blocks do); 24 blocks per room from ``sample_blocks``.
    Returns ``(features [24 * num_rooms, num_points, 9] float32, labels
    [24 * num_rooms, num_points] int64)``."""
    r = np.random.default_rng(seed)
    feats, labels = [], []
    for i in range(num_rooms):
        n = 20000 if num_points <= 4096 else 5 * num_points
        pts = np.zeros((n, 6), np.float32)
        pts[:, 0] = r.uniform(0, 4, n)
        pts[:, 1] = r.uniform(0, 3, n)
        pts[:, 2] = r.uniform(0, 2.5, n)
        pts[:, 3:6] = r.uniform(0, 255, (n, 3))
        lab = np.digitize(pts[:, 2], [0.8, 1.7]).astype(np.int64)  # three bands
        bx, by = sample_blocks(pts, lab, num_blocks=24, num_points=num_points,
                               rng=np.random.default_rng(seed + i))
        feats.append(bx)
        labels.append(by)
    return np.concatenate(feats), np.concatenate(labels)
