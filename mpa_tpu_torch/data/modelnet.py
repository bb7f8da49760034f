"""ModelNet10/40 reader (a copy of ``mpa_tpu/data/modelnet.py``).

Reference semantics: ``ModelNetDataLoader``
(dataset/ModelNetDataLoader.py:44-132): one comma-separated xyz+normal
``.txt`` a shape, the class list ``modelnet{10,40}_shape_names.txt``, the
split lists ``modelnet{10,40}_{train,test}.txt``, ``pc_normalize``, an
optional offline FPS down to ``num_point`` (else the first ``num_point``
rows) and the ``use_normals`` channel slice.

The processed split is cached in a ``.npz`` beside the data with the same
file name, keys and source fingerprint as ``mpa_tpu``'s, so a cache written
by either package serves the other. The fingerprint (a hash of the split
list, and every source file's whole-second mtime and size, compared for
equality) is checked on load, so an updated dataset is parsed again; when
the sources are gone the cache is trusted as it is.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Tuple

import numpy as np

from mpa_tpu_torch.data.native_io import fps_indices, loadtxt
from mpa_tpu_torch.data.shapenetpart import pc_normalize


def load_modelnet(
    root: str,
    split: str = "train",
    num_category: int = 40,
    num_point: int = 1024,
    use_normals: bool = False,
    use_fps: bool = False,
    limit: Optional[int] = None,
    cache: bool = True,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """``(points [M, num_point, C] float32, labels [M] int64, class names)``."""
    with open(os.path.join(root, f"modelnet{num_category}_shape_names.txt")) as f:
        classes = [line.strip() for line in f]
    cls_index = {c: i for i, c in enumerate(classes)}
    with open(os.path.join(root, f"modelnet{num_category}_{split}.txt")) as f:
        ids = [line.strip() for line in f]
    if limit is not None:
        ids = ids[:limit]

    ids_hash = hashlib.sha1("\n".join(ids).encode()).hexdigest()[:10]
    h = hashlib.sha1()
    any_src = False
    for shape_id in ids:
        name = "_".join(shape_id.split("_")[:-1])
        try:
            st = os.stat(os.path.join(root, name, shape_id + ".txt"))
        except OSError:
            continue
        h.update(f"{shape_id}:{int(st.st_mtime)}:{st.st_size};".encode())
        any_src = True
    src_digest = h.hexdigest()[:16] if any_src else ""
    cache_path = os.path.join(
        root,
        f"mpa_cache_mn{num_category}_{split}_{num_point}pts"
        f"_{'fps' if use_fps else 'head'}_{'n' if use_normals else 'xyz'}"
        f"_{len(ids)}.npz",
    )
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        stored_hash = str(z["ids_hash"]) if "ids_hash" in z else ""
        stored_digest = str(z["src_digest"]) if "src_digest" in z else None
        if stored_hash == ids_hash and (src_digest == "" or stored_digest == src_digest):
            return z["points"], z["labels"], classes

    C = 6 if use_normals else 3
    pts = np.zeros((len(ids), num_point, C), np.float32)
    labels = np.zeros((len(ids),), np.int64)
    for i, shape_id in enumerate(ids):
        name = "_".join(shape_id.split("_")[:-1])
        cloud = loadtxt(os.path.join(root, name, shape_id + ".txt"), 6)  # xyz + normal
        cloud = cloud[fps_indices(cloud, num_point)] if use_fps else cloud[:num_point]
        cloud[:, :3] = pc_normalize(cloud[:, :3])
        pts[i] = cloud[:, :C]
        labels[i] = cls_index[name]
    if cache:
        try:
            tmp = cache_path + ".tmp.npz"
            np.savez(tmp, points=pts, labels=labels, ids_hash=ids_hash, src_digest=src_digest)
            os.replace(tmp, cache_path)
        except OSError:
            pass  # a read-only dataset root runs uncached
    return pts, labels, classes
