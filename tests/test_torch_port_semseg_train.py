"""Port parity, markov_semseg training, on the CPU.

``mpa_tpu`` runs as its own tests run it (JAX on the CPU: the windowed ops
take their references there); the port takes its plain ops, because the
tensors lie on the CPU. Covered, in the ``window_all`` mode the card runs:
the eval-mode gradients of every parameter and of the input blocks, two SGD
steps of the ``s3dis_semseg`` recipe against ``mpa_tpu``'s train step,
dropout from the caller's generator; and the preset, the S3DIS block
features and sampling, the synthetic rooms, ``semseg_iou`` and a two-step
``cli.train --preset s3dis_semseg`` run. The kernels and their backward are
held against the plain versions on the card (``tests/test_torch_port_cuda.py``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import _nest, jax_variables, port  # noqa: E402
from test_torch_port_semseg import _blocks  # noqa: E402
from test_torch_port_train import _jax_state_to_port  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.cli.train import _semseg_synthetic as jax_semseg_synthetic  # noqa: E402
from mpa_tpu.configs.presets import PRESETS as JAX_PRESETS  # noqa: E402
from mpa_tpu.data import s3dis as jax_s3dis  # noqa: E402
from mpa_tpu.models import MarkovSemSeg as JaxMarkovSemSeg  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS, model_kwargs  # noqa: E402
from mpa_tpu_torch.data import (  # noqa: E402
    block_features,
    sample_blocks,
    semseg_iou,
    synthetic_semseg,
)
from mpa_tpu_torch.models import MarkovSemSeg  # noqa: E402
from mpa_tpu_torch.train import (  # noqa: E402
    TRAIN_STEPS,
    create_train_state,
    make_schedule,
    make_semseg_train_step,
)

CPU = torch.device("cpu")
# A three-scale ladder keeps JAX's compile of the train step short; the
# band floors are low enough that every encoder FPS bands.
WINDOW_ALL = dict(num_classes=5, npoints=(128, 64, 32), channels=(8, 8, 8, 16),
                  residuals=(True, False, False, True), neighbor_mode="window_all",
                  fps_min_band=32, fps_min_samples=8)


def _point_nll(log_probs, seg):
    return -torch.gather(log_probs, 2, seg[..., None].long()).mean()


def test_semseg_eval_grads_match_mpa_tpu():
    """Eval-mode gradients of a mean per-point NLL with respect to every
    parameter and the input blocks, window_all with banded FPS, at atol 1e-4
    and rtol 1e-3 (the bounds of the part-seg gradient test). They run
    through the windowed attention's backward, the windowed scatter-mean's
    and the Morton sort's gather. The seed keeps every pre-activation clear
    of 0: at seed 11 one of head2's lies within a last bit of it, the leaky
    ReLU's slope there (1 or 0.2) depends on that bit, and head2's weight
    gradient moves by 1.1e-3 between float32 runs (the port's own float64
    run agrees with ``mpa_tpu`` there to 2e-7)."""
    x = _blocks(12)
    seg = np.random.default_rng(13).integers(0, 5, (2, 256))
    jm = JaxMarkovSemSeg(**WINDOW_ALL)
    flat = jax_variables(jm, jnp.asarray(x))
    nested = _nest(flat)

    def jloss(params, pts):
        out = jm.apply({"params": params, "batch_stats": nested["batch_stats"]}, pts,
                       train=False)
        return -jnp.mean(jnp.take_along_axis(out, jnp.asarray(seg)[..., None], -1))

    jg_params, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(nested["params"], jnp.asarray(x))
    model, unused = port(MarkovSemSeg(**WINDOW_ALL), flat)
    assert unused == []
    xt = torch.from_numpy(x).requires_grad_(True)
    _point_nll(model(xt), torch.from_numpy(seg)).backward()
    want = _jax_state_to_port(type("S", (), {"params": jg_params, "batch_stats": {}})(), model)
    grads = {n: p.grad for n, p in model.named_parameters()}
    for name, w in want.items():
        g = grads[name] if grads[name] is not None else torch.zeros_like(w)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-3, atol=1e-4)
    assert float(xt.grad.abs().max()) > 0


def test_semseg_sgd_steps_match_mpa_tpu():
    """Two steps of the ``s3dis_semseg`` recipe (SGD 0.1, momentum 0.9, wd
    1e-4, cosine to 1e-3, smoothing 0.1; dropout 0, since the frameworks
    cannot share its random bits) in window_all, from the same weights on
    the same batches: after each step the loss, every updated parameter and
    the running statistics. The limits are the part-seg test's (whose
    reasons hold here): step 1 loss 1e-5 and every entry 1e-4; step 2 loss
    1e-3, every entry 2e-2 and all but 0.1% of them 1e-3. The batches are
    free of near-ties: at another seed (20) the banded feature search flips
    one neighbour on a last bit between XLA's sums and the port's, and
    train-mode BatchNorm spreads the flip over 967 of 1024 points (largest
    log-prob difference 0.117)."""
    cfg = PRESETS["s3dis_semseg"]
    B, N, spe = 4, 256, 4
    limits = [dict(loss=1e-5, entry=1e-4, most=1e-5, share=1e-3),
              dict(loss=1e-3, entry=2e-2, most=1e-3, share=1e-3)]
    xs = [_blocks(21 + i, B, N) for i in range(2)]
    segs = [np.random.default_rng(30 + i).integers(0, 5, (B, N)) for i in range(2)]
    jm = JaxMarkovSemSeg(dropout=0.0, **WINDOW_ALL)
    nested = _nest(flat := jax_variables(jm, jnp.asarray(xs[0])))
    sched = jtr.cosine_schedule(cfg.learning_rate, cfg.epochs, cfg.eta_min)
    tx = jtr.make_optimizer("sgd", lambda step: sched(step // spe), cfg.weight_decay, cfg.momentum)
    jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"], tx=tx,
                                   batch_stats=nested["batch_stats"])
    jstep = jax.jit(jtr.make_train_step(lambda out, y: jtr.smooth_seg_loss(out, y, 0.1)))
    model, _ = port(MarkovSemSeg(dropout=0.0, **WINDOW_ALL), flat)
    state = create_train_state(model, cfg, CPU)
    step = make_semseg_train_step(cfg, spe)
    for i, (x, seg, limit) in enumerate(zip(xs, segs, limits)):
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(seg), jax.random.key(0))
        loss = float(step(state, torch.from_numpy(x), torch.from_numpy(seg)))
        assert abs(loss - float(jloss)) <= limit["loss"], f"step {i}: {loss} vs {float(jloss)}"
        want = _jax_state_to_port(jstate, model)
        got = model.state_dict()
        off = total = 0
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            diff = (got[name] - w).abs()
            assert float(diff.max()) <= limit["entry"], (
                f"after step {i}: {name} off by {float(diff.max())}")
            off += int((diff > limit["most"]).sum())
            total += diff.numel()
        assert total > 20_000 and off <= limit["share"] * total, (
            f"after step {i}: {off} of {total} entries off by > {limit['most']}")


def test_semseg_dropout_draws_from_the_callers_generator():
    x = torch.from_numpy(_blocks(40))
    model = MarkovSemSeg(**WINDOW_ALL).train()
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    a = model(x, generator=torch.Generator().manual_seed(1))
    b = model(x, generator=torch.Generator().manual_seed(1))
    c = model(x, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# -- preset, data, metrics ------------------------------------------------------------------


def test_semseg_preset_matches_mpa_tpu():
    want, cfg = JAX_PRESETS["s3dis_semseg"], PRESETS["s3dis_semseg"]
    for field in ("task", "model", "num_classes", "num_points", "batch_size", "optimizer",
                  "learning_rate", "weight_decay", "momentum", "scheduler", "eta_min", "epochs",
                  "seed", "label_smoothing", "neighbor_mode", "fps_min_band", "fps_min_samples"):
        assert getattr(cfg, field) == getattr(want, field), field
    kw = model_kwargs(cfg)
    assert kw["npoints"] == (2048, 1024, 512, 256) and kw["num_classes"] == 13
    big = model_kwargs(cfg.with_overrides(num_points=16384, neighbor_mode="window_all"))
    assert big["npoints"] == (8192, 4096, 2048, 1024) and big["neighbor_mode"] == "window_all"
    jsched = jtr.cosine_schedule(want.learning_rate, want.epochs, want.eta_min)
    for epoch in (0, 50, 99, 100):  # JAX's schedule rounds to float32
        np.testing.assert_allclose(make_schedule(cfg)(epoch), float(jsched(epoch)), rtol=1e-5)
    assert TRAIN_STEPS["semseg"] is make_semseg_train_step


def test_s3dis_blocks_and_synthetic_rooms_match_mpa_tpu():
    rng = np.random.default_rng(3)
    room = np.concatenate([rng.uniform(0, 3, (500, 3)), rng.uniform(0, 255, (500, 3))], 1)
    room = room.astype(np.float32)
    labels = rng.integers(0, 13, 500)
    lo, hi, centre = room[:, :3].min(0), room[:, :3].max(0), np.array([1.0, 2.0])
    np.testing.assert_array_equal(block_features(room[:50], lo, hi, centre),
                                  jax_s3dis.block_features(room[:50], lo, hi, centre))
    for got, want in zip(sample_blocks(room, labels, 3, 128, rng=np.random.default_rng(5)),
                         jax_s3dis.sample_blocks(room, labels, 3, 128,
                                                 rng=np.random.default_rng(5))):
        np.testing.assert_array_equal(got, want)
    for num_points in (256, 8192):  # both room densities
        got = synthetic_semseg(1, num_points, seed=4)
        want = jax_semseg_synthetic(1, num_points, 4)
        assert got[0].shape == (24, num_points, 9) and got[0].dtype == np.float32
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert set(np.unique(got[1])) <= {0, 1, 2}  # three height bands


def test_semseg_iou_matches_mpa_tpu():
    rng = np.random.default_rng(6)
    pred, target = rng.integers(0, 13, 4000), rng.integers(0, 13, 4000)
    pred[(pred == 4) & (target != 4)] = 3
    pred[target == 4] = 4  # a class predicted exactly
    pred[pred == 12] = 11  # a class never predicted, still in the target
    target[target == 7] = 8
    pred[pred == 7] = 8  # a class in neither: IoU NaN, left out of the mean
    got, want = semseg_iou(pred, target), jax_s3dis.semseg_iou(pred, target)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])
    assert np.isnan(got[2][7]) and got[2][4] == 1.0 and got[2][12] == 0.0


# -- the entry point ----------------------------------------------------------------------


def test_cli_train_semseg_two_steps_on_cpu(capsys):
    kernels.reset_launch_counts()
    out = cli_train.main(["--preset", "s3dis_semseg", "--device", "cpu", "--max_steps", "2",
                          "--batch_size", "2", "--num_points", "256", "--train_clouds", "6",
                          "--eval_clouds", "3", "--neighbor_mode", "window_all", "--seed", "0"])
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert 0.0 <= out["block_miou"] <= 1.0 and 0.0 <= out["point_acc"] <= 1.0
    log = capsys.readouterr().out
    assert "model markov_semseg" in log and "neighbor_mode='window_all'" in log
    assert "block-mIoU" in log and "over 3 blocks" in log
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only
