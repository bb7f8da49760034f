"""``python -m mpa_tpu_torch.cli.export`` on the CPU (counterpart of
``tests/test_serve.py``'s CLI tests).

The preset ``scanobjectnn_cls`` at its full width, 1024 points, exported
with ``--device cpu --serve_batch 1`` from an adam-l2 checkpoint that the
port's ``BestCheckpointer`` wrote: the restore is weights-only, so the
optimizer's state does not have to match the export's lr-0 SGD (the
regression ``tests/test_serve.py::test_export_cli_restores_adam_checkpoint``
holds for ``mpa_tpu``). The loaded artifact's answers are bit-equal to the
eager model restored from the same checkpoint. One export only: the
preset's FPS ladder, traced op by op on the CPU, takes about a minute.

``mpa_tpu``'s own CLI test exports at ``--num_points 64``, where its FPS
samples 512 of 64 points without complaint; the port's refuses that ladder
before it traces anything (``ROADMAP.md`` Queue 3, "Not port faults").
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)

from mpa_tpu_torch.cli import export as export_cli  # noqa: E402
from mpa_tpu_torch.cli.eval import eval_state  # noqa: E402
from mpa_tpu_torch.configs import PRESETS  # noqa: E402
from mpa_tpu_torch.serve import load_inference  # noqa: E402
from mpa_tpu_torch.train.checkpoint import BestCheckpointer  # noqa: E402
from mpa_tpu_torch.train.loop import TrainState, make_optimizer  # noqa: E402


def _adam_checkpoint(directory) -> None:
    """A checkpoint of ``scanobjectnn_cls`` after one adam-l2 step (zero
    gradients: the step still fills Adam's moments and applies the weight
    decay), with BatchNorm statistics that differ from a fresh init."""
    cfg = PRESETS["scanobjectnn_cls"]
    state = eval_state(cfg, torch.device("cpu"))
    state = TrainState(state.model, make_optimizer("adam-l2", state.model.parameters(),
                                                   cfg.learning_rate, cfg.weight_decay))
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    gen = torch.Generator().manual_seed(7)
    for name, buf in state.model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
    assert state.optimizer.state and BestCheckpointer(str(directory)).save_if_best(state, 0.5)


def test_export_cli_restores_adam_checkpoint(tmp_path):
    ckpt, out = tmp_path / "ckpt", str(tmp_path / "cls.pt2")
    _adam_checkpoint(ckpt)
    manifest = export_cli.main(["--preset", "scanobjectnn_cls", "--checkpoint", str(ckpt),
                                "--serve_batch", "1", "--out", out, "--device", "cpu"])
    man = json.load(open(out + ".json"))
    assert man == {**man, **manifest} and man["train_best_metric"] == 0.5
    assert man["in_avals"] == ["float32[1, 1024, 3]"] and man["out_avals"] == ["float32[1, 15]"]
    assert man["device"] == "cpu" and man["model"] == "markov_cls"

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1024, 3))
                         .astype(np.float32))
    got = load_inference(out)(x)
    state = eval_state(PRESETS["scanobjectnn_cls"], torch.device("cpu"))
    assert BestCheckpointer(str(ckpt)).restore(state, restore_optimizer=False) is not None
    with torch.no_grad():
        want = state.model(x)
    assert got.shape == (1, 15) and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_export_cli_refuses_a_ladder_longer_than_the_cloud(tmp_path):
    """At ``--num_points 64`` the preset's first FPS takes 512 of 64 points:
    refused, where ``mpa_tpu`` samples out of range without complaint."""
    with pytest.raises(ValueError, match=r"npoint=512 must be in \[1, N=64\]"):
        export_cli.main(["--preset", "scanobjectnn_cls", "--num_points", "64",
                         "--serve_batch", "2", "--out", str(tmp_path / "m.pt2"),
                         "--device", "cpu"])
    assert not os.path.exists(tmp_path / "m.pt2")
