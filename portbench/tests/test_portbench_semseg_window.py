"""The ``markov_semseg_s3dis_window_all`` configuration and its cell
``semseg-window-train``: the reference against ``mpa_tpu_torch`` on the CPU
at a small size (a served answer, the first training steps), the operation
count against ``FlopCounterMode`` and against the searches the reference
makes, and a whole tiny run of the cell, which comes out correct while the
planted faults and the control do not."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import faults, weights
from portbench.conftest import ROOT
from portbench.configs import markov_semseg_s3dis_window_all as cfg
from portbench.reference import ops, window_ops
from portbench.reference.layers import calibrate, weight_table
from portbench.tests.test_portbench_faults import result
from portbench.tests.test_portbench_reference import program_inputs
from portbench.traffic import s3dis_rooms

CPU = torch.device("cpu")
CELL = "semseg-window-train"
N = 256  # the ladder 128/64/32/16 admits a window at every scale pair


def _sizes(n=N):
    sizes = json.loads((ROOT / "portbench/configs/markov_semseg_s3dis_window_all.json")
                       .read_text())
    sizes.update(num_points=n, npoints=[n >> (i + 1) for i in range(4)])
    return sizes


def _setup():
    sizes = _sizes()
    ref = cfg.reference(sizes)
    ref.load_state_dict(weights.make(weight_table(ref), 1234, CPU))
    return sizes, ref, s3dis_rooms.make(4, N, 99, {})


def test_served_answers_match():
    sizes, ref, data = _setup()
    calibrate(ref, lambda: cfg.reference_forward(ref, *cfg.request_tensors(data, CPU)))
    call, model = cfg.serve_program(sizes, 0, CPU)
    weights.load_into_program(model, ref.state_dict())
    got = call(data)
    with torch.no_grad():
        want = cfg.reference_forward(ref, *cfg.request_tensors(data, CPU))
    assert got.shape == want.shape == (4, N, 13)
    assert float((got - want).abs().max()) < 1e-4
    assert all(v < 1e-5 for v in cfg.compare_answers(got, want).values())


def test_training_steps_match():
    from portbench import check, program
    from portbench.reference import train as rtrain

    sizes, ref, data = _setup()
    wts = {k: v.clone() for k, v in ref.state_dict().items()}
    arrays = cfg.train_arrays(data)
    trainer = program.Trainer(sizes, 77, 2, 2, CPU)
    assert trainer.model.neighbor_mode == "window_all"  # from the preset
    weights.load_into_program(trainer.model, wts)
    host = [tuple(a[i * 2:(i + 1) * 2] for a in arrays) for i in range(2)]
    losses = []
    for i, batch in enumerate(host):
        losses.append(float(trainer.step(*program_inputs(trainer, batch))))
        if i == 0:
            taken = {n: float(g.norm()) for n, g in trainer.taken_gradients().items()}
    params = dict(trainer.model.named_parameters())
    prog = {"losses": losses, "grad": taken,
            "change": {n: float((params[n].detach() - wts[n]).norm()) for n in params}}
    out = rtrain.follow(ref, cfg.reference_forward, [cfg.reference_batch(b, CPU) for b in host],
                        sizes["optimizer"], 77, 2, sizes["augment"])
    numbers = check.train_numbers(prog, out)
    numbers["loss_gap"] = max(abs(p - r) / abs(r) for p, r in zip(losses, out["losses"]))
    assert numbers["loss_gap"] < 1e-4 and numbers["grad_gap"] < 1e-3, numbers


def test_count_is_the_references_products():
    sizes = _sizes(128)
    model = cfg.reference(sizes)
    model.load_state_dict(weights.make(weight_table(model), 9, CPU))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.eval()(torch.rand(2, 128, 9))
    assert cfg.count_ops(sizes, 2, 128)["matmul"] == int(counter.get_total_flops())


def test_count_is_the_references_searches(monkeypatch):
    """Each search the reference makes, counted as ``roofline.bound`` counts
    the launch: windowed at every pair of the 2048-point ladder."""
    counted = []
    windowed, exact = window_ops.windowed_knn, ops.knn

    def windowed_knn(k, base, query, spec):
        B, n_base, C = base.shape
        S = query.shape[1]
        counted.append(B * S * spec.window * (2 * C + 3) + 2 * B * (S + n_base) * C
                       + 3 * B * S * k * C)
        return windowed(k, base, query, spec)

    def knn(k, base, query, rows=1 << 25):
        counted.append(None)  # no search of the cell's ladder is exact
        return exact(k, base, query, rows)

    monkeypatch.setattr(window_ops, "windowed_knn", windowed_knn)
    monkeypatch.setattr(ops, "knn", knn)
    sizes = _sizes(2048)
    model = cfg.reference(sizes)
    model.load_state_dict(weights.make(weight_table(model), 9, CPU))
    with torch.no_grad():
        model.eval()(torch.from_numpy(s3dis_rooms.make(2, 2048, 5, {})["points"]))
    assert len(counted) == 22 and None not in counted
    assert cfg.count_ops(sizes, 2, 2048)["knn"] == sum(counted)


def test_the_cell_is_correct_at_a_tiny_size(tiny):
    line = result(tiny, CELL)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_fault_is_caught(tiny, fault):
    assert not result(tiny, CELL, fault=faults.TRAIN[fault])["correct"]


def test_the_control_is_caught(tiny):
    assert not result(tiny, CELL, "--control", "1")["correct"]
