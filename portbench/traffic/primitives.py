"""Composed surface primitives, the clouds both traffic generators draw.

A frozen copy of ``mpa_tpu_torch/data/synthetic.py``'s ``_unit_primitive``,
``_rotation_z``, ``_class_spec`` and ``_compose_cloud``, so that the
benchmark's traffic does not move when the program's generators change.
``tests/test_portbench_counts.py`` holds the copy to the original.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def unit_primitive(rng: np.random.Generator, kind: int, n: int) -> np.ndarray:
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


def rotation_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def class_spec(class_seed: int, num_prims: int):
    """Fixed-per-class primitive layout: (kind, offset, per-axis scale, rot)."""
    rng = np.random.default_rng(class_seed)
    spec = []
    for _ in range(num_prims):
        kind = int(rng.integers(0, 6))
        offset = rng.uniform(-0.55, 0.55, size=3)
        scale = rng.uniform(0.2, 0.6, size=3)
        rot = rotation_z(float(rng.uniform(0, 2 * np.pi)))
        spec.append((kind, offset, scale, rot))
    return spec


def compose_cloud(rng: np.random.Generator, spec, num_points: int,
                  weights: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """A cloud drawn on a class spec: ``(points [num_points, 3] float32,
    primitive id of each point)``, with a random z-rotation, a uniform scale,
    jitter, and the centring and unit-radius scaling of ``pc_normalize``."""
    k = len(spec)
    if weights is None:
        weights = np.full(k, 1.0 / k)
    counts = np.maximum(1, (weights * num_points).astype(int))
    counts[0] += num_points - counts.sum()
    parts, ids = [], []
    for j, ((kind, offset, scale, rot), c) in enumerate(zip(spec, counts)):
        p = unit_primitive(rng, kind, c) * scale @ rot.T + offset
        parts.append(p)
        ids.append(np.full(c, j, dtype=np.int64))
    pts = np.concatenate(parts, axis=0)
    pid = np.concatenate(ids, axis=0)
    perm = rng.permutation(num_points)
    pts, pid = pts[perm], pid[perm]
    pts = pts @ rotation_z(float(rng.uniform(0, 2 * np.pi))).T
    pts = pts * float(rng.uniform(0.9, 1.1))
    pts = pts + rng.normal(scale=0.01, size=pts.shape)
    pts = pts - pts.mean(axis=0, keepdims=True)
    pts = pts / (np.max(np.linalg.norm(pts, axis=-1)) + 1e-9)
    return pts.astype(np.float32), pid
