"""A whole run of each cell on the CPU at a tiny size, the look for a card
skipped: the program comes out correct, and every planted fault and the
control (the reference in TF32 in the program's place) come out not
correct."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench import faults, run

TRAIN = ["partseg-train", "dgcnn-train"]
SERVE = ["partseg-serve", "dgcnn-serve"]


def result(tiny, cell, *extra, fault=None, device=torch.device("cpu")):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "3000000019", "--seconds", "0.3",
                       "--trace", "0", *extra], root=tiny, device=device, fault=fault)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    checks = err.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert all(c.startswith("check ") and " limit " in c for c in checks)
    assert list(line)[-1] == "checks"
    return line


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_program_is_correct(tiny, cell):
    line = result(tiny, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_caught(tiny, cell, fault):
    assert not result(tiny, cell, fault=faults.TRAIN[fault])["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answer_is_caught(tiny, cell):
    assert not result(tiny, cell, fault=faults.altered)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_altered_quarter_is_caught(tiny, cell):
    """A quarter of each cloud's answers altered, which a median over a
    cloud's points does not see."""
    assert not result(tiny, cell, fault=faults.altered_quarter)["correct"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_is_caught(tiny, cell):
    assert not result(tiny, cell, "--control", "1")["correct"]


def test_no_card_no_result(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", "dgcnn-serve", "--seed", "1", "--seconds", "1"], root=tiny)
    assert rc != 0 and out.getvalue() == "" and "CUDA" in err.getvalue()


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_is_caught_on_card(card, cell):
    """At the cell's own size, with cuBLAS's own TF32."""
    assert not result(run.ROOT, cell, "--control", "1", device=card)["correct"]
