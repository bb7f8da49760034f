"""Port parity, markov_partseg training, on the CPU.

``mpa_tpu`` runs as its own tests run it (JAX on the CPU: the scatter-mean
takes its ``segment_sum`` form and XLA differentiates it, the attention takes
``_xla_reference``); the port takes its plain ops, because the tensors lie on
the CPU. Covered: the whole model's eval-mode gradients against the frozen
torch oracle, two SGD steps of the ``shapenetpart`` recipe against
``mpa_tpu``'s train step (losses, parameters, BatchNorm statistics), the SGD
loss curve against the frozen torch curve, the per-point loss, the part-seg
metrics, the schedules, the preset and the synthetic data against their
``mpa_tpu`` twins, dropout from the caller's generator, and a two-step
``cli.train --preset shapenetpart`` run. The scatter-mean kernel and its
backward are held against the plain version on the card
(``tests/test_torch_port_cuda.py``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle_cache import oracle  # noqa: E402
from test_torch_port_cls import _nest, _x, jax_variables, port  # noqa: E402
from test_torch_port_partseg import LADDER, NARROW, _seg_inputs, _variables  # noqa: E402
from test_torch_port_train import _jax_state_to_port, _params_of  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.configs.presets import PRESETS as JAX_PRESETS  # noqa: E402
from mpa_tpu.data import realistic_partseg as jax_realistic_partseg  # noqa: E402
from mpa_tpu.data import synthetic_partseg as jax_synthetic_partseg  # noqa: E402
from mpa_tpu.data.shapenetpart import SEG_PARTS as JAX_SEG_PARTS  # noqa: E402
from mpa_tpu.data.shapenetpart import to_categorical as jax_to_categorical  # noqa: E402
from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu.train import metrics as jax_metrics  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS, model_kwargs  # noqa: E402
from mpa_tpu_torch.data import (  # noqa: E402
    SEG_PARTS,
    realistic_partseg,
    synthetic_partseg,
    to_categorical,
)
from mpa_tpu_torch.models import MarkovPartSeg  # noqa: E402
from mpa_tpu_torch.train import (  # noqa: E402
    category_masked_argmax,
    create_train_state,
    make_partseg_train_step,
    make_schedule,
    make_train_step,
    part_iou_metrics,
    smooth_seg_loss,
)
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402

CPU = torch.device("cpu")


def _point_nll(log_probs, seg):
    return -torch.gather(log_probs, 2, seg[..., None]).mean()


# -- gradients ------------------------------------------------------------------------


def test_partseg_eval_grads_match_frozen_oracle():
    """Eval-mode gradients of a mean per-point NLL with respect to every
    parameter and the input cloud, against ``partseg_grads.npz`` at atol 1e-4,
    rtol 1e-3 (the bounds of ``test_grad_parity.py``). They run through the
    scatter-mean's gradient 14 times and through ``mid_op``'s bias handling."""
    fwd = oracle("partseg_model_forward", lambda: pytest.fail("fixture missing"))
    f = oracle("partseg_grads", lambda: pytest.fail("fixture partseg_grads.npz missing"))
    model, _ = port(MarkovPartSeg(npoints=LADDER), _variables(fwd))
    x = torch.from_numpy(f["x"]).requires_grad_(True)
    loss = _point_nll(model((x, torch.from_numpy(f["onehot"]))),
                      torch.from_numpy(f["seg"].astype(np.int64)))
    loss.backward()
    assert abs(float(loss.detach()) - float(f["loss"])) < 5e-5
    want_flat = {"params/" + k[len("want_params/"):]: v
                 for k, v in f.items() if k.startswith("want_params/")}
    want, unused = from_jax_variables(want_flat, model)
    assert unused == []
    params = _params_of(model)
    assert set(want) == set(params) and len(params) > 400
    for name, p in params.items():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=f"grad mismatch at {name}")
    np.testing.assert_allclose(x.grad.numpy(), f["want_x"], atol=1e-4, rtol=1e-3)


# -- the train step -------------------------------------------------------------------


def test_sgd_steps_match_mpa_tpu():
    """Two steps of the ``shapenetpart`` recipe (SGD 0.1, momentum 0.9, wd
    1e-4, cosine to 1e-3, smoothing 0.1; dropout 0, since the two frameworks
    cannot share its random bits) from the same weights on the same batches,
    at narrow widths: after each step the loss, every updated parameter and
    the running statistics.

    Tolerances. Step 1 starts from identical weights: loss within 1e-5, every
    entry of the state within 1e-4 (the largest difference read 2.4e-5: lr
    0.1 times the rounding of a gradient). Step 2 starts from those slightly
    different weights, and train-mode BatchNorm and the near-tie selections
    (feature kNN, max over K, max pool) amplify the difference in its
    gradients: loss within 1e-3 (read 1.4e-4), every entry within 2e-2 (read
    3.9e-3), and all but 0.1% of the entries within 1e-3 (read 0.026%). SGD
    keeps a gradient's size, where Adam in the cls test divides it away, so
    no entry needs a bound of the step's own size."""
    cfg = PRESETS["shapenetpart"]
    assert (cfg.optimizer, cfg.learning_rate, cfg.momentum, cfg.weight_decay, cfg.scheduler,
            cfg.eta_min) == ("sgd", 0.1, 0.9, 1e-4, "cos", 1e-3)
    B, N, spe = 8, 256, 4
    limits = [dict(loss=1e-5, entry=1e-4, most=1e-5, share=1e-3),
              dict(loss=1e-3, entry=2e-2, most=1e-3, share=1e-3)]
    batches = [_seg_inputs(20 + i, B, N) for i in range(len(limits))]
    segs = [np.random.default_rng(30 + i).integers(0, 50, (B, N)) for i in range(len(limits))]
    jm = JaxMarkovPartSeg(dropout=0.0, **NARROW)
    flat = jax_variables(jm, tuple(jnp.asarray(a) for a in batches[0]))
    nested = _nest(flat)

    sched = jtr.cosine_schedule(cfg.learning_rate, cfg.epochs, cfg.eta_min)
    tx = jtr.make_optimizer("sgd", lambda step: sched(step // spe), cfg.weight_decay, cfg.momentum)
    jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"], tx=tx,
                                   batch_stats=nested["batch_stats"])
    jstep = jax.jit(jtr.make_train_step(lambda out, y: jtr.smooth_seg_loss(out, y, 0.1)))
    model, _ = port(MarkovPartSeg(dropout=0.0, **NARROW), flat)
    state = create_train_state(model, cfg, CPU)
    step = make_partseg_train_step(cfg, spe)
    for i, ((x, oh), seg, limit) in enumerate(zip(batches, segs, limits)):
        jstate, jloss = jstep(jstate, (jnp.asarray(x), jnp.asarray(oh)), jnp.asarray(seg),
                              jax.random.key(0))
        loss = float(step(state, (torch.from_numpy(x), torch.from_numpy(oh)),
                          torch.from_numpy(seg)))
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
        assert total > 400_000 and off <= limit["share"] * total, (
            f"after step {i}: {off} of {total} entries off by > {limit['most']}")
    assert state.step == len(limits)


def test_partseg_sgd_curve_tracks_frozen_torch_curve():
    """15 SGD steps (lr 2e-3, no momentum, plain per-point NLL, dropout 0)
    from the frozen curve's weights on its batches, under the limits of
    ``test_training_equivalence.py::TestPartSegTrainingCurveEquivalence``."""
    f = oracle("partseg_train_curve", lambda: pytest.fail("fixture partseg_train_curve.npz missing"))
    want = f["want"]
    steps, lr, B, N = len(want), 2e-3, 2, 256
    r = np.random.default_rng(11)
    xs = r.normal(size=(2, B, N, 3)).astype(np.float32)
    cats = r.integers(0, 16, size=(2, B))
    ohs = np.eye(16, dtype=np.float32)[cats]
    segs = r.integers(0, 50, size=(2, B, N))
    model, unused = port(MarkovPartSeg(npoints=LADDER, dropout=0.0), _variables(f))
    assert unused == []
    state = create_train_state(model, PRESETS["shapenetpart"].with_overrides(
        optimizer="sgd", learning_rate=lr, weight_decay=0.0, momentum=0.0), CPU)
    step = make_train_step(_point_nll, lambda epoch: lr, steps)
    got = np.asarray([
        float(step(state, (torch.from_numpy(xs[i % 2]), torch.from_numpy(ohs[i % 2])),
                   torch.from_numpy(segs[i % 2]))) for i in range(steps)])
    diff = np.abs(got - want)
    assert diff[0] < 1e-3, f"step-0 loss mismatch: {got[0]} vs {want[0]}"
    assert float(diff.mean()) < 0.12, (
        f"curves diverge: got {got.round(4).tolist()} want {want.round(4).tolist()}")
    assert want[-1] < want[0] - 0.05 and got[-1] < got[0] - 0.05
    assert abs((want[0] - want[-1]) - (got[0] - got[-1])) < 0.1


def test_partseg_dropout_draws_from_the_callers_generator():
    x, onehot = (torch.from_numpy(a) for a in _seg_inputs(40))
    model = MarkovPartSeg(dropout=0.5, **NARROW).train()
    with pytest.raises(ValueError, match="Generator"):
        model((x, onehot))
    a = model((x, onehot), generator=torch.Generator().manual_seed(1))
    b = model((x, onehot), generator=torch.Generator().manual_seed(1))
    c = model((x, onehot), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# -- loss, metrics, schedules, preset, data ------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_smooth_seg_loss_matches_mpa_tpu(smoothing):
    logp = torch.log_softmax(torch.from_numpy(_x(41, (3, 20, 50))), -1)
    y = np.random.default_rng(42).integers(0, 50, (3, 20))
    want = jtr.smooth_seg_loss(jnp.asarray(logp.numpy()), jnp.asarray(y), smoothing)
    got = smooth_seg_loss(logp, torch.from_numpy(y), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("quirk", [False, True])
def test_partseg_metrics_match_mpa_tpu(quirk):
    assert SEG_PARTS == JAX_SEG_PARTS and len(SEG_PARTS) == 16
    assert sorted(p for parts in SEG_PARTS for p in parts) == list(range(50))
    rng = np.random.default_rng(5)
    B, N = 12, 64
    logits = rng.standard_normal((B, N, 50)).astype(np.float32)
    cats = rng.integers(0, 16, B)
    cats[:2] = 0
    targets = np.stack([rng.choice(SEG_PARTS[c], N) for c in cats])
    targets[0] = SEG_PARTS[0][0]  # the other parts of shape 0 are absent from its target
    want = jax_metrics.category_masked_argmax(logits, cats, JAX_SEG_PARTS, quirk)
    got = category_masked_argmax(logits, cats, SEG_PARTS, quirk)
    np.testing.assert_array_equal(got, want)
    if not quirk:  # every prediction is a part of its shape's category
        assert all(set(got[b]) <= set(SEG_PARTS[cats[b]]) for b in range(B))
    got[0] = targets[0]  # shape 0: right everywhere, absent parts count 1.0
    w_ins, w_cls, w_cat = jax_metrics.part_iou_metrics(list(got), list(targets), list(cats),
                                                      JAX_SEG_PARTS)
    g_ins, g_cls, g_cat = part_iou_metrics(list(got), list(targets), list(cats), SEG_PARTS)
    assert (g_ins, g_cls, g_cat) == (w_ins, w_cls, w_cat)
    assert part_iou_metrics([got[0]], [targets[0]], [0], SEG_PARTS)[0] == 1.0
    np.testing.assert_array_equal(to_categorical(cats), jax_to_categorical(cats))


@pytest.mark.parametrize("epoch", [0, 1, 150, 299, 300, 400])
def test_preset_schedule_matches_mpa_tpu(epoch):
    want = JAX_PRESETS["shapenetpart"]
    cfg = PRESETS["shapenetpart"]
    for field in ("task", "model", "num_points", "batch_size", "optimizer", "learning_rate",
                  "weight_decay", "momentum", "scheduler", "eta_min", "epochs", "seed",
                  "label_smoothing"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert (cfg.num_parts, cfg.num_categories) == (50, 16)
    assert model_kwargs(cfg)["npoints"] == (1024, 512, 256, 128)
    jsched = jtr.cosine_schedule(want.learning_rate, want.epochs, want.eta_min)
    np.testing.assert_allclose(make_schedule(cfg)(epoch), float(jsched(epoch)), rtol=1e-6)
    cls = PRESETS["scanobjectnn_cls"]
    jstep = jtr.step_decay_schedule(cls.learning_rate, cls.decay_step, cls.decay_gamma)
    np.testing.assert_allclose(make_schedule(cls)(epoch), float(jstep(epoch)), rtol=1e-6)
    with pytest.raises(ValueError):
        make_schedule(cfg.with_overrides(scheduler="linear"))


def test_synthetic_partseg_data_matches_mpa_tpu():
    for mine, theirs in ((realistic_partseg, jax_realistic_partseg),
                         (synthetic_partseg, jax_synthetic_partseg)):
        got, want = mine(10, 128, seed=3), theirs(10, 128, seed=3)
        assert len(got) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    pts, cats, labels = realistic_partseg(10, 128, seed=3)
    assert all(set(labels[i]) <= set(SEG_PARTS[cats[i]]) for i in range(10))


# -- the entry point ----------------------------------------------------------------------


def test_cli_train_partseg_two_steps_on_cpu(capsys):
    kernels.reset_launch_counts()
    out = cli_train.main(["--preset", "shapenetpart", "--device", "cpu", "--max_steps", "2",
                          "--batch_size", "2", "--num_points", "256", "--train_clouds", "8",
                          "--eval_clouds", "3", "--seed", "0"])
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert 0.0 <= out["ins_miou"] <= 1.0 and 0.0 <= out["class_miou"] <= 1.0
    log = capsys.readouterr().out
    assert "model markov_partseg" in log and "step 2 (epoch 0): loss" in log
    assert "ins-mIoU" in log and "over 3 clouds" in log
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only


def test_cli_train_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--preset", "shapenetpart", "--max_steps", "1"])


def test_attention_plain_sums_the_denominator_in_neighbour_order():
    """The plain attention, forward and backward, adds ``E`` over the
    neighbours one after the other, as the kernels do. With ``E = [2^24, 1,
    1, ...]`` each ``+ 1`` rounds away in that order, so the first
    neighbour's ``attn`` is exactly 0; any other order of the sum gives a
    larger denominator. A last-bit difference there is what lets the plain
    version and the kernel give the maximum over K to different neighbours."""
    from mpa_tpu_torch.ops.attention import attention_bwd_plain, attention_plain

    K, c = 8, 4
    packed = torch.ones((1, K, 2 * c))
    packed[0, 0, :c] = 2.0 ** 24
    idx = torch.arange(K, dtype=torch.int32).reshape(1, 1, K)
    ctx = attention_plain(packed, idx, None, 1, c)
    assert (ctx == 0).all()  # max_k (E_k / denom - 1) * 1 with denom == 2^24 exactly
    dpacked, _ = attention_bwd_plain(packed, idx, None, torch.ones((1, 1, c)), 1, c)
    assert (dpacked[0, 0, c:] == 0).all()  # dV of the maximum: dw * attn = 0
    assert (dpacked[0, 1:, c:] == 0).all()
