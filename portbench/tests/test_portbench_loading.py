"""The benchmark is driven by data: a cell and a metric are added as files
and entries in a copy of ``portbench/``, and the harness lists, validates
and loads them with no other edit."""

from __future__ import annotations

import json
import shutil

import pytest

from portbench import spec
from portbench.conftest import ROOT

METRIC = '''"""A test metric: the profiled units."""


def read(record):
    return float(record["units"]) if record["kind"] == "serve" else None
'''


def test_the_benchmark_validates():
    bench = spec.load_benchmark(ROOT)
    assert spec.validate(bench) == []
    for w in bench["workloads"]:
        cell = spec.load_cell(bench, w["name"])
        assert cell.kind in spec.KINDS and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)


@pytest.fixture
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cell_and_a_metric_added_as_files(copy):
    pkg = copy / "portbench"
    params = json.loads((pkg / "workloads" / "dgcnn-serve.json").read_text())
    params.update(batch=32, traffic="serve_closed_32x1024")
    (pkg / "workloads" / "dgcnn-serve-32.json").write_text(json.dumps(params))
    (pkg / "metrics" / "profiled_units.serve.py").write_text(METRIC)
    bench = spec.load_benchmark(copy)
    bench["workloads"].append({"name": "dgcnn-serve-32", "config": "dgcnn_scanobjectnn",
                               "traffic": "serve_closed_32x1024", "chips": 1,
                               "why": "a smaller batch"})
    for m in bench["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("dgcnn-serve-32")
    bench["per_layer"].append({"name": "profiled_units.serve", "unit": "units",
                               "better": "higher", "source": "program_counter",
                               "layer": "serve entry", "moves": "serve_clouds_per_s",
                               "workloads": ["dgcnn-serve-32"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.validate(spec.load_benchmark(copy), pkg) == []
    cell = spec.load_cell(spec.load_benchmark(copy), "dgcnn-serve-32", pkg)
    assert cell.params["batch"] == 32
    readers = spec.reader_functions(cell)
    assert readers["profiled_units.serve"]({"kind": "serve", "units": 10}) == 10.0
    assert "profiled_units.serve" not in {m["name"] for m in spec.load_cell(
        spec.load_benchmark(copy), "dgcnn-serve", pkg).per_layer}


def test_missing_files_are_listed(copy):
    pkg = copy / "portbench"
    (pkg / "workloads" / "dgcnn-train.json").unlink()
    (pkg / "metrics" / "mfu.serve.py").unlink()
    problems = spec.validate(spec.load_benchmark(copy), pkg)
    assert any("dgcnn-train" in p for p in problems)
    assert any("mfu.serve" in p for p in problems)


def test_a_cell_that_disagrees_with_its_entry_is_listed(copy):
    pkg = copy / "portbench"
    path = pkg / "workloads" / "partseg-serve.json"
    params = json.loads(path.read_text())
    params["traffic"] = "something_else"
    path.write_text(json.dumps(params))
    assert any("traffic" in p for p in spec.validate(spec.load_benchmark(copy), pkg))
