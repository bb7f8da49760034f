"""No module of the benchmark imports JAX or the JAX package, and a process
that loads the whole harness and the program's entries holds none of them:
compared by whole top-level names (``mpa_tpu_torch`` is not ``mpa_tpu``)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import run
from portbench.conftest import ROOT

SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def _imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not _imported(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_reads_nothing_of_the_jax_benchmark(path):
    if path.parent.name == "tests":
        return
    text = path.read_text()
    assert not any(s in text for s in ("bench.py", "BENCH_", "docs/PERF.md", "BASELINE.json"))


def test_a_loaded_harness_holds_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import importlib, pathlib\n"
        "from portbench import run, spec, harness, calibrate, faults, readings\n"
        "root = pathlib.Path(%r)\n"
        "bench = spec.load_benchmark(root)\n"
        "for w in bench['workloads']:\n"
        "    cell = spec.load_cell(bench, w['name'])\n"
        "    cell.config(); cell.generator(); spec.reader_functions(cell)\n"
        "import mpa_tpu_torch.serve, mpa_tpu_torch.train, mpa_tpu_torch.cli.train\n"
        "import mpa_tpu_torch.data.pipeline, mpa_tpu_torch.kernels.build\n"
        "print(run.forbidden_modules())\n" % (str(ROOT), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mpa_tpu_torch_fake", object())
    assert run.forbidden_modules() == [] or "mpa_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
