"""The plain references against ``mpa_tpu_torch`` on the CPU at a small size,
from one table of weights: the served answers, and the first training steps
(losses, the gradient the optimizer took, each leaf's change)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import check, program, weights
from portbench.conftest import ROOT
from portbench.configs import dgcnn_scanobjectnn, markov_partseg_shapenetpart
from portbench.reference import ops
from portbench.reference import train as rtrain
from portbench.reference.layers import calibrate, weight_table
from portbench.traffic import shapenetpart_parts, surface_clouds

CPU = torch.device("cpu")
N = 128
CONFIGS = {
    "markov_partseg_shapenetpart": (markov_partseg_shapenetpart, shapenetpart_parts,
                                    {"npoints": [64, 32, 16, 8]}),
    "dgcnn_scanobjectnn": (dgcnn_scanobjectnn, surface_clouds, {}),
}


def _setup(name):
    mod, gen, extra = CONFIGS[name]
    sizes = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    sizes.update(num_points=N, **extra)
    ref = mod.reference(sizes)
    ref.load_state_dict(weights.make(weight_table(ref), 1234, CPU))
    data = gen.make(4, N, 99, {"num_classes": sizes.get("num_classes", 15)})
    return mod, sizes, ref, data


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_served_answers_match(name):
    mod, sizes, ref, data = _setup(name)
    calibrate(ref, lambda: mod.reference_forward(ref, *mod.request_tensors(data, CPU)))
    call, model = mod.serve_program(sizes, 0, CPU)
    weights.load_into_program(model, ref.state_dict())
    got = call(data)
    with torch.no_grad():
        want = mod.reference_forward(ref, *mod.request_tensors(data, CPU))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4
    assert all(v < 1e-5 for v in mod.compare_answers(got, want).values())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_training_steps_match(name):
    mod, sizes, ref, data = _setup(name)
    wts = {k: v.clone() for k, v in ref.state_dict().items()}
    arrays = mod.train_arrays(data)
    trainer = program.Trainer(sizes, 77, 2, 2, CPU)
    weights.load_into_program(trainer.model, wts)
    host = [tuple(a[i * 2:(i + 1) * 2] for a in arrays) for i in range(2)]
    losses = []
    for i, batch in enumerate(host):
        inputs, labels = program_inputs(trainer, batch)
        losses.append(float(trainer.step(inputs, labels)))
        if i == 0:
            taken = {n: float(g.norm()) for n, g in trainer.taken_gradients().items()}
    params = dict(trainer.model.named_parameters())
    prog = {"losses": losses, "grad": taken,
            "change": {n: float((params[n].detach() - wts[n]).norm()) for n in params}}
    out = rtrain.follow(ref, mod.reference_forward, [mod.reference_batch(b, CPU) for b in host],
                        sizes["optimizer"], 77, 2, sizes["augment"])
    numbers = check.train_numbers(prog, out)
    numbers["loss_gap"] = max(abs(p - r) / abs(r) for p, r in zip(losses, out["losses"]))
    assert numbers["loss_gap"] < 1e-4 and numbers["grad_gap"] < 1e-4, numbers


def program_inputs(trainer, batch):
    from mpa_tpu_torch.cli.train import host_batch

    inputs, labels = host_batch(trainer.cfg, batch)
    convert = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    inputs = tuple(map(convert, inputs)) if isinstance(inputs, tuple) else convert(inputs)
    return inputs, convert(labels)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -2.5, 3.0e-30])
    got = ops.round_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 and got[2] == 1.0 + 2 * 2.0 ** -10
    assert got[3] == -2.5 and abs(float(got[4]) - 3.0e-30) < 3.0e-30 * 2.0 ** -10


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_served_answers_match_on_card(card, name):
    """The program's kernels against the reference on the card."""
    ops.full_float32()
    mod, sizes, ref, data = _setup(name)
    ref = ref.to(card)
    calibrate(ref, lambda: mod.reference_forward(ref, *mod.request_tensors(data, card)))
    call, model = mod.serve_program(sizes, 0, card)
    weights.load_into_program(model, ref.state_dict())
    with torch.no_grad():
        want = mod.reference_forward(ref, *mod.request_tensors(data, card))
    assert all(v < 1e-4 for v in mod.compare_answers(call(data), want).values())
