"""Build and load the port's CUDA kernels.

Every ``.cu`` file under ``kernels/csrc/`` is compiled for Hopper
(``sm_90a``) with ``nvcc`` into one shared library with a plain C interface,
``kernels/_build/libmpa_kernels.so``, which is loaded with ``ctypes``. The
build runs at first use, one ``nvcc`` per source started together, and is
keyed by a hash of the sources and flags: a library built from other sources
is rebuilt, never loaded.

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libmpa_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
ptxas_log: str = ""


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built on the machine with the card"
        )
    return found


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def build(force: bool = False) -> Path:
    """Compile the sources into ``_build/libmpa_kernels.so`` unless a library
    built from the same sources is already there. Returns its path."""
    global build_seconds, ptxas_log
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if not force and lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / (p.stem + ".o") for p in cus]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cus, objs)
        ]
        logs, failed = [], []
        for src, p in zip(cus, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        ptxas_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{ptxas_log}")
        tmp_lib = Path(tmp) / LIB_NAME
        _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-o", str(tmp_lib), *map(str, objs)])
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return lib_path


_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mpa_knn": [_VP] * 5 + [_I] * 5 + [_VP],
    "mpa_fps": [_VP, _VP, _I, _VP] + [_I] * 8 + [_VP],
    "mpa_gather_rows": [_VP, _VP, _VP] + [_I] * 7 + [_VP],
    "mpa_transition_attention_fwd": [_VP] * 4 + [_I] * 8 + [_VP],
    "mpa_scatter_add_rows": [_VP] * 4 + [_I] * 7 + [_VP],
    "mpa_transition_attention_bwd": [_VP] * 7 + [_I] * 7 + [_VP],
    "mpa_scatter_mean": [_VP] * 5 + [_I] * 8 + [_VP],
    "mpa_windowed_knn": [_VP] * 4 + [_I] * 10 + [_VP],
    "mpa_windowed_attention_fwd": [_VP] * 4 + [_I] * 8 + [_VP],
    "mpa_windowed_attention_bwd": [_VP] * 7 + [_I] * 7 + [_VP],
    "mpa_windowed_scatter_mean": [_VP] * 5 + [_I] * 11 + [_VP],
    "mpa_ball_query": [_VP, _VP, _VP] + [_I] * 5 + [ctypes.c_float, _I, _VP],
    "mpa_batch_norm_act": [_VP] * 9 + [_I] * 10 + [ctypes.c_float] * 4 + [_I, _VP],
    "mpa_batch_norm_act_bwd": [_VP] * 10 + [_I] * 11 + [_VP],
    "mpa_empty": [_VP],
}


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry's
    argument and return types. Each entry returns a ``cudaError_t``."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronise would not report it)."""
    if err != 0:
        msg = load().mpa_error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {err}: {msg(err).decode()}")
