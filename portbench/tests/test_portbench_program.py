"""The readers of the program's own spans and counters
(``portbench/program_trace.py``): the two counter metrics against the
program's counters after a tiny run, and the span readers, the idle gaps by
program span and the block device times on synthetic records."""

from __future__ import annotations

import io
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench import program_trace as pt
from portbench import run, spec
from portbench.conftest import ROOT

NEW = {"host_syncs.serve": ("partseg-serve", "dgcnn-serve"),
       "input_empty_share.train": ("partseg-train", "dgcnn-train")}


def test_the_counter_metrics_are_entries_with_files():
    bench = spec.load_benchmark(ROOT)
    assert spec.validate(bench) == []
    for name, cells in NEW.items():
        for cell in cells:
            assert name in spec.reader_functions(spec.load_cell(bench, cell))


def test_counter_readers_on_counts():
    found = {"host_syncs.serve.input_copy": 4, "host_syncs.serve.category_read": 4,
             "host_syncs.window.check": 0, "serve_calls": 2, "input_waits": 8, "input_empty": 2}
    assert pt.host_syncs({}, found) == 4.0
    assert pt.input_empty_share({}, found) == 25.0
    idle = dict(found, serve_calls=0, input_waits=0)
    assert pt.host_syncs({}, idle) is None and pt.input_empty_share({}, idle) is None


def test_counter_readers_give_none_for_a_program_without_counters(monkeypatch):
    from mpa_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "COUNTS")
    assert pt.counts() is None
    assert pt.host_syncs({}) is None and pt.input_empty_share({}) is None


@pytest.mark.parametrize("cell, metric, want", [("partseg-serve", "host_syncs.serve", 2.0),
                                                ("dgcnn-serve", "host_syncs.serve", 0.0)])
def test_a_tiny_run_moves_the_counters(tiny, cell, metric, want):
    """On the CPU a serve call copies nothing to a card: the part-seg call's
    two category reads remain."""
    from mpa_tpu_torch.utils import profiling

    profiling.reset_counts()
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()):
        assert run.main(["--workload", cell, "--seed", "2147483659", "--seconds", "0.2"],
                        root=tiny, device=torch.device("cpu")) == 0
    assert profiling.COUNTS["serve_calls"] > 2
    read = spec.reader_functions(spec.load_cell(spec.load_benchmark(tiny), cell,
                                                tiny / "portbench"))[metric]
    assert read({}) == want


def _record():
    """Two train units: device work with gaps at 1.0-1.2 (inside the
    forward's block.la0), 2.0-2.5 (the backward, a producer span open too)
    and 3.0-3.1 (no program span: the benchmark's loss_read); block.la0
    launched two operations of 0.2 and 0.1 s."""
    ops = [("k", 0.0, 1.0), ("k", 1.2, 2.0), ("k", 2.5, 3.0), ("k", 3.1, 3.2)]
    spans = [("train.step", None, 0, "MainThread", 0.5, 2.6),
             ("train.forward", "train.step", 0, "MainThread", 0.6, 1.5),
             ("block.la0", "train.forward", 0, "MainThread", 0.7, 1.4),
             ("train.backward", "train.step", 0, "MainThread", 1.6, 2.6),
             ("train.optimizer", "train.step", 0, "MainThread", 2.6, 2.7),
             ("train.augment", None, 0, "MainThread", 0.45, 0.5),
             ("pipeline.pin", None, 3, "prefetch_to_device", 1.9, 2.6)]
    host = [("dispatch", 0.4, 2.8), ("loss_read", 2.9, 3.2)]
    return {"kind": "train", "units": 2,
            "trace": {"device_ops": ops, "host_spans": [("dispatch", 0.4, 2.6)],
                      "start": 0.0, "end": 3.2},
            "program_trace": {"device_ops": ops, "host_spans": host, "start": 0.0, "end": 3.2,
                              "launched": [(0.75, 0.8, 1.0), (1.3, 1.2, 1.3),
                                           (1.45, 1.3, 1.5), (0.3, 0.0, 0.7)]},
            "program_spans": spans,
            "program_counts": {"num_device_alloc": 3.0, "num_device_free": 2.5,
                               "serve_calls": 0.0}}


def test_program_breakdown_labels_gaps_by_the_innermost_program_span():
    got = pt.program_breakdown(_record())
    assert [n for n, _ in got["program_idle_gaps"]] == ["train.backward", "block.la0",
                                                        "loss_read"]
    assert got["program_idle_gaps"][0][1] == pytest.approx(0.5)
    assert got["block_device_ms"] == {"block.la0": pytest.approx(150.0)}
    assert pt.program_breakdown({"kind": "train"}) is None


def test_span_readers_and_the_program_block():
    rec = _record()
    got = pt.program_block(rec)
    assert got["metrics"] == {"forward_ms.train": pytest.approx(450.0),
                              "backward_ms.train": pytest.approx(500.0),
                              "optimizer_ms.train": pytest.approx(50.0),
                              "allocator_calls.train": 5.5}
    assert got["dispatch_ms"] == [pytest.approx(2200.0), pytest.approx(2400.0)]
    assert got["spans_on_cost_pct"] == pytest.approx(100 * 200 / 2200)
    # train.augment 0.45-0.5 and train.step 0.5-2.6 within dispatch 0.4-2.8
    assert got["dispatch_covered_pct"] == pytest.approx(100 * 2.15 / 2.4)
    assert got["unit_ms"] == [pytest.approx(1600.0)] * 2 and got["spans_a_unit"] == 3.5
    assert got["span_named_device_ops"] == 0
    assert got["span_ms"]["train.step"] == pytest.approx(1050.0) and len(got["span_ms"]) == 7
    assert pt.span_ms({"units": 1}, "serve.inputs") is None
    assert pt.allocator_calls({}) is None
    assert set(pt.SPAN_READERS["serve"]) == {"inputs_ms.serve", "forward_ms.serve",
                                             "allocator_calls.serve"}
