"""ScanObjectNN (15 classes) h5 reader (a copy of
``mpa_tpu/data/scanobjectnn.py``).

Reference semantics: ``ScanObjectNNDataLoader``
(dataset/ScanObjectNNDataLoader.py:8-31) reads
``{root}/main_split[_nobg]/{split}_objectdataset_augmentedrot_scale75.h5``,
datasets ``data`` float32 ``[M, 2048, 3]`` and ``label`` int; the clouds
stay channel-last here. The published variant (PB_T50_RS) has 11416
training and 2882 test clouds of exactly 2048 points. ``h5py`` is imported
when a split is read, so importing the port needs no ``h5py``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

NUM_CLASSES = 15


def load_scanobjectnn(root: str, split: str = "training",
                      background: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """``(points [M, 2048, 3] float32, labels [M] int64)``; split
    ``training`` or ``test``."""
    import h5py

    subdir = "main_split" if background else "main_split_nobg"
    path = os.path.join(root, subdir, f"{split}_objectdataset_augmentedrot_scale75.h5")
    with h5py.File(path, "r") as f:
        points = f["data"][:].astype(np.float32)
        labels = f["label"][:].astype(np.int64)
    return points, labels
