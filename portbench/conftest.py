"""Shared fixtures of the benchmark's tests: the card (tests that need one
skip without it) and a copy of the benchmark cut to a size the CPU runs in
seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# The widths stay published; the clouds, batches and pools shrink.
TINY_POINTS = 128
TINY_CELL = {"batch": 4, "points": TINY_POINTS, "calibration_clouds": 4, "pool_requests": 3}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    return torch.device("cuda", 0)


def make_tiny(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``dest`` whose
    configurations and cells are cut to ``TINY_POINTS``-point clouds in
    batches of 4."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / "portbench" / "configs" / f"{c['name']}.json"
        sizes = json.loads(path.read_text())
        sizes["num_points"] = TINY_POINTS
        if "npoints" in sizes:
            sizes["npoints"] = [TINY_POINTS >> (i + 1) for i in range(len(sizes["npoints"]))]
        path.write_text(json.dumps(sizes))
    for w in bench["workloads"]:
        path = dest / "portbench" / "workloads" / f"{w['name']}.json"
        params = json.loads(path.read_text())
        params.update({k: v for k, v in TINY_CELL.items() if k in params})
        path.write_text(json.dumps(params))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))
