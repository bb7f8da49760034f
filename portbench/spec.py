"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root names the
cells, configurations and metrics; each is found in a file of its own by
its name.

- a cell ``<name>``: ``portbench/workloads/<name>.json`` (its kind, batch,
  points, traffic generator and parameters, check sizes and limits);
- a configuration ``<config>``: ``portbench/configs/<config>.json`` (the
  sizes as run) and ``portbench/configs/<config>.py`` (the program's entry,
  the reference, the comparison of answers, the operation count);
- a traffic generator ``<generator>``: ``portbench/traffic/<generator>.py``;
- a per-layer metric ``<metric>``: ``portbench/metrics/<metric>.py``, whose
  ``read(record)`` returns the metric or None.

:func:`validate` lists every problem it finds; adding a cell or a metric
means adding its file and its entry, and nothing else.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

PKG = Path(__file__).resolve().parent
KINDS = ("train", "serve")
CELL_KEYS = {
    "train": ("config", "traffic", "kind", "batch", "points", "generator", "pool_batches",
              "check_steps", "profile_units", "limits"),
    "serve": ("config", "traffic", "kind", "batch", "points", "generator", "pool_requests",
              "check_requests", "calibration_clouds", "profile_units", "limits"),
}


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    params: dict  # workloads/<name>.json
    sizes: dict  # configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    pkg: Path

    @property
    def kind(self) -> str:
        return self.params["kind"]

    def config(self) -> ModuleType:
        c = self.params["config"]
        return load_module(self.pkg / "configs" / f"{c}.py", f"portbench.configs.{c}")

    def generator(self) -> ModuleType:
        g = self.params["generator"]
        return load_module(self.pkg / "traffic" / f"{g}.py", f"portbench.traffic.{g}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.pkg / "metrics" / f"{metric}.py", f"portbench.metrics.{metric}")


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str):
    """``(end_to_end, per_layer)`` entries that cell ``cell`` reports: those
    that list it, and those without a list (a per-layer one where the cell
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench.get("per_layer", [])
                 if cell in m.get("workloads", ()) or ("workloads" not in m
                                                       and m["moves"] in names)]
    return e2e, per_layer


def load_cell(bench: dict, name: str, pkg: Path = PKG) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    with open(pkg / "workloads" / f"{name}.json") as f:
        params = json.load(f)
    with open(pkg / "configs" / f"{params['config']}.json") as f:
        sizes = json.load(f)
    e2e, per_layer = cell_metrics(bench, name)
    return Cell(name, entries[name], params, sizes, e2e, per_layer, pkg)


def validate(bench: dict, pkg: Path = PKG) -> List[str]:
    """Every problem of ``bench`` against the files under ``pkg``; empty when
    each cell, configuration, generator and metric has its files and the
    cells agree with their entries."""
    problems: List[str] = []
    configs = {c["name"] for c in bench.get("configs", [])}
    for c in bench.get("configs", []):
        for suffix in (".json", ".py"):
            if not (pkg / "configs" / f"{c['name']}{suffix}").is_file():
                problems.append(f"config {c['name']}: no configs/{c['name']}{suffix}")
    for w in bench.get("workloads", []):
        path = pkg / "workloads" / f"{w['name']}.json"
        if not path.is_file():
            problems.append(f"cell {w['name']}: no {path.relative_to(pkg)}")
            continue
        with open(path) as f:
            params = json.load(f)
        kind = params.get("kind")
        if kind not in KINDS:
            problems.append(f"cell {w['name']}: kind {kind!r} is not one of {KINDS}")
            continue
        problems += [f"cell {w['name']}: no key {k!r}" for k in CELL_KEYS[kind] if k not in params]
        for key in ("config", "traffic"):
            if params.get(key) != w.get(key):
                problems.append(f"cell {w['name']}: {key} {params.get(key)!r} is "
                                f"{w.get(key)!r} in BENCHMARK.json")
        if w.get("config") not in configs:
            problems.append(f"cell {w['name']}: config {w.get('config')!r} is not listed")
        gen = params.get("generator")
        if gen and not (pkg / "traffic" / f"{gen}.py").is_file():
            problems.append(f"cell {w['name']}: no traffic/{gen}.py")
        e2e, per_layer = cell_metrics(bench, w["name"])
        if not per_layer:
            problems.append(f"cell {w['name']}: reports no per-layer metric")
        if not any(m["name"] != "setup_s" for m in e2e):
            problems.append(f"cell {w['name']}: reports no end-to-end metric but setup_s")
    for m in bench.get("per_layer", []):
        if not (pkg / "metrics" / f"{m['name']}.py").is_file():
            problems.append(f"metric {m['name']}: no metrics/{m['name']}.py")
    return problems


def reader_functions(cell: Cell) -> Dict[str, object]:
    """The ``read`` function of each per-layer metric the cell reports."""
    return {m["name"]: cell.reader(m["name"]).read for m in cell.per_layer}
