"""ShapeNetPart: 16 categories / 50 global part labels (a copy of
``mpa_tpu/data/shapenetpart.py``; the tables are reference
tool/train_partseg.py:21-41).

Reference semantics: ``PartNormalDataset`` (dataset/ShapeNetDataLoader.py:27-147):
the category map of ``synsetoffset2category.txt``, the split lists, one
``x y z nx ny nz seg`` text file a shape, ``pc_normalize``. Data root
(shapenetcore_partanno_segmentation_benchmark_v0_normal):

    {root}/synsetoffset2category.txt                  (16 lines: name, synset)
    {root}/train_test_split/shuffled_{train,val,test}_file_list.json
    {root}/<synset>/<uuid>.txt                        (rows: x y z nx ny nz seg)

The clouds are ragged (about 500-3000 points) and are resampled to
``npoints`` on the host from ``np.random.default_rng(seed)``, as
``mpa_tpu`` does (the reference ran FPS in its DataLoader workers).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from mpa_tpu_torch.data.native_io import loadtxt

# Category -> global part labels.
SEG_CLASSES: Dict[str, List[int]] = {
    "Earphone": [16, 17, 18],
    "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43],
    "Car": [8, 9, 10, 11],
    "Laptop": [28, 29],
    "Cap": [6, 7],
    "Skateboard": [44, 45, 46],
    "Mug": [36, 37],
    "Guitar": [19, 20, 21],
    "Bag": [4, 5],
    "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49],
    "Airplane": [0, 1, 2, 3],
    "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15],
    "Knife": [22, 23],
}

# Alphabetical category order, the order that indexes the one-hot labels.
CATEGORIES: List[str] = sorted(SEG_CLASSES.keys())
SEG_PARTS: List[List[int]] = [SEG_CLASSES[c] for c in CATEGORIES]
NUM_CATEGORIES = len(CATEGORIES)
NUM_PARTS = 50


def to_categorical(labels: np.ndarray, num_classes: int = NUM_CATEGORIES) -> np.ndarray:
    """One-hot encode ``[B]`` -> ``[B, num_classes]`` float32."""
    return np.eye(num_classes, dtype=np.float32)[labels]


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Centre and scale to unit maximum radius (reference pc_normalize)."""
    pc = pc - pc.mean(axis=0)
    m = np.max(np.sqrt(np.sum(pc**2, axis=1)))
    return pc / max(m, 1e-12)


def _resample_to(points: np.ndarray, seg: np.ndarray, n: int,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Exactly ``n`` points of a ragged cloud: a draw without replacement
    when it has enough, else with replacement."""
    choice = rng.choice(len(points), n, replace=len(points) < n)
    return points[choice], seg[choice]


class ShapeNetPartDataset:
    """In-memory ShapeNetPart reader; ``ds[i]`` is ``(points [npoints, C],
    category, seg [npoints])``, resampled afresh on every read."""

    def __init__(self, root: str, split: str = "trainval", npoints: int = 2048,
                 use_normals: bool = False, seed: int = 0):
        self.root = root
        self.npoints = npoints
        self.use_normals = use_normals
        self._rng = np.random.default_rng(seed)

        self.cat2synset: Dict[str, str] = {}
        with open(os.path.join(root, "synsetoffset2category.txt")) as f:
            for line in f:
                name, synset = line.strip().split()
                self.cat2synset[name] = synset
        synset2cat = {v: k for k, v in self.cat2synset.items()}

        files: List[str] = []
        for s in (["train", "val"] if split == "trainval" else [split]):
            with open(os.path.join(root, "train_test_split", f"shuffled_{s}_file_list.json")) as f:
                files += json.load(f)
        self.items: List[Tuple[str, int]] = []
        for fp in files:
            synset = fp.split("/")[1]
            path = os.path.join(root, synset, fp.split("/")[2] + ".txt")
            self.items.append((path, CATEGORIES.index(synset2cat[synset])))
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int, np.ndarray]:
        if i in self._cache:
            data, seg = self._cache[i]
        else:
            raw = loadtxt(self.items[i][0], 7)  # x y z nx ny nz seg
            data = raw[:, :6] if self.use_normals else raw[:, :3]
            data[:, :3] = pc_normalize(data[:, :3])
            seg = raw[:, -1].astype(np.int64)
            if len(self._cache) < 20000:
                self._cache[i] = (data, seg)
        pts, seg = _resample_to(data, seg, self.npoints, self._rng)
        return pts, self.items[i][1], seg


def load_split(root: str, split: str, npoints: int = 2048, use_normals: bool = False,
               limit: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A whole split as dense arrays ``(points, categories, segs)``."""
    ds = ShapeNetPartDataset(root, split, npoints, use_normals)
    n = len(ds) if limit is None else min(limit, len(ds))
    pts = np.zeros((n, npoints, 6 if use_normals else 3), np.float32)
    cats = np.zeros((n,), np.int64)
    segs = np.zeros((n, npoints), np.int64)
    for i in range(n):
        pts[i], cats[i], segs[i] = ds[i]
    return pts, cats, segs
