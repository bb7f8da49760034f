"""ctypes bindings to the native point-cloud text parser and host FPS
(``native/pointio.cpp``; a copy of ``mpa_tpu/data/native_io.py``'s).

The library is compiled on first use with ``g++ -O3`` into the port's own
ignored build directory (``mpa_tpu_torch/kernels/_build/``), never into
``native/build/``, which is ``mpa_tpu``'s. It is rebuilt when the source is
newer, written under a temporary name and renamed into place, so concurrent
processes never load a half-written file. Every entry point falls back to
numpy when the compiler or the library is unavailable, with the same
results; :func:`native_available` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "pointio.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "mpa_tpu_torch", "kernels", "_build")
_SO_NAME = "libpointio.so"

_lib = None
_lock = threading.Lock()

_P_FLOAT = ctypes.POINTER(ctypes.c_float)
_P_LONG = ctypes.POINTER(ctypes.c_long)


def _build(so: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, so)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SRC):
            return None
        so = os.path.join(_BUILD_DIR, _SO_NAME)
        stale = os.path.exists(so) and os.path.getmtime(_SRC) > os.path.getmtime(so)
        if (not os.path.exists(so) or stale) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        lib.pointio_parse_file.restype = ctypes.c_long
        lib.pointio_parse_file.argtypes = [ctypes.c_char_p, _P_FLOAT, ctypes.c_long, ctypes.c_int]
        lib.pointio_parse_many.restype = None
        lib.pointio_parse_many.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                                           _P_FLOAT, _P_LONG, ctypes.c_long, ctypes.c_int,
                                           ctypes.c_int]
        lib.pointio_fps.restype = None
        lib.pointio_fps.argtypes = [_P_FLOAT, ctypes.c_long, ctypes.c_int, ctypes.c_long, _P_LONG]
        lib.pointio_fps_many.restype = None
        lib.pointio_fps_many.argtypes = [_P_FLOAT, _P_LONG, ctypes.c_long, ctypes.c_long,
                                         ctypes.c_int, ctypes.c_long, _P_LONG, ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native library runs, False when numpy stands in."""
    return _load() is not None


def loadtxt(path: str, n_cols: int, max_rows: int = 1 << 18) -> np.ndarray:
    """``np.loadtxt`` of a numeric point file (whitespace or comma) as
    float32 ``[rows, n_cols]``."""
    lib = _load()
    if lib is None:
        with open(path) as f:
            delim = None if " " in f.readline() else ","
        return np.loadtxt(path, delimiter=delim).astype(np.float32)
    out = np.empty((max_rows, n_cols), np.float32)
    rows = lib.pointio_parse_file(path.encode(), out.ctypes.data_as(_P_FLOAT), max_rows, n_cols)
    if rows < 0:
        raise FileNotFoundError(path)
    if rows >= max_rows:
        raise ValueError(f"{path}: file has >= max_rows={max_rows} rows; raise max_rows "
                         "(refusing to truncate)")
    return out[:rows].copy()


def _fps_numpy(points: np.ndarray, n: int) -> np.ndarray:
    """Reference offline FPS (dataset/ModelNetDataLoader.py:20-41): start at
    row 0, min-distance table, first-occurrence argmax."""
    N = points.shape[0]
    out = np.zeros((n,), dtype=np.int64)
    dist = np.full((N,), np.inf)
    far = 0
    for i in range(n):
        out[i] = far
        d = np.sum((points[:, :3] - points[far, :3]) ** 2, axis=-1)
        dist = np.minimum(dist, d)
        far = int(np.argmax(dist))
    return out


def fps_indices(points: np.ndarray, n: int) -> np.ndarray:
    """Exact host FPS indices ``[n]`` of one cloud ``[N, C >= 3]`` (native,
    or the numpy fallback with the same picks)."""
    lib = _load()
    if lib is None:
        return _fps_numpy(np.asarray(points, np.float32), n)
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty((n,), np.int64)
    lib.pointio_fps(pts.ctypes.data_as(_P_FLOAT), pts.shape[0], pts.shape[1], n,
                    out.ctypes.data_as(_P_LONG))
    return out


def fps_indices_many(points: np.ndarray, counts: np.ndarray, n: int,
                     n_threads: int = 16) -> np.ndarray:
    """Threaded FPS over a padded batch ``[M, max_pts, C]`` with per-cloud
    row counts ``[M]`` (padding rows ignored); indices ``[M, n]``."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    cnt = np.ascontiguousarray(counts, np.int64)
    if lib is None:
        return np.stack([_fps_numpy(pts[i, :cnt[i]], n) for i in range(pts.shape[0])])
    out = np.empty((pts.shape[0], n), np.int64)
    lib.pointio_fps_many(pts.ctypes.data_as(_P_FLOAT), cnt.ctypes.data_as(_P_LONG),
                         pts.shape[0], pts.shape[1], pts.shape[2], n,
                         out.ctypes.data_as(_P_LONG), n_threads)
    return out


def loadtxt_many(paths: List[str], n_cols: int, max_rows: int = 1 << 15,
                 n_threads: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded whole-split load: (data ``[F, max_rows, n_cols]``, row counts
    ``[F]``); the fallback is a sequential numpy loop."""
    lib = _load()
    n = len(paths)
    if lib is None:
        data = np.zeros((n, max_rows, n_cols), np.float32)
        counts = np.zeros((n,), np.int64)
        for i, p in enumerate(paths):
            arr = np.loadtxt(p).astype(np.float32)[:max_rows]
            data[i, :len(arr)] = arr[:, :n_cols]
            counts[i] = len(arr)
        return data, counts
    data = np.empty((n, max_rows, n_cols), np.float32)
    counts = np.empty((n,), np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.pointio_parse_many(c_paths, n, data.ctypes.data_as(_P_FLOAT),
                           counts.ctypes.data_as(_P_LONG), max_rows, n_cols, n_threads)
    return data, counts
