"""Port parity, markov_cls training, on the CPU.

``mpa_tpu`` runs as its own tests run it (JAX on the CPU, so
``transition_attention`` takes ``_xla_reference`` and ``gather_neighbors``
its ``segment_sum`` VJP); the port takes its plain ops, because the tensors
lie on the CPU. Covered: BatchNorm train mode against flax, the gradients of
the row gather and the transition attention against ``jax.grad`` (tied
maxima, duplicate indices, an eps-floored row) and against torch autograd of
the plain forwards, the whole classifier's eval-mode gradients against the
frozen torch oracle, two ``adam-l2`` steps against ``mpa_tpu``'s train step,
the SGD loss curve against the frozen torch curve, the losses, schedules,
metrics and synthetic data against their ``mpa_tpu`` twins, and a two-step
``cli.train`` run. The backward kernels themselves are held against the
plain versions on the card (``tests/test_torch_port_cuda.py``).
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
from test_torch_port_cls import SMALL, _nest, _x, jax_variables, port  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.data import synthetic_clouds as jax_synthetic_clouds  # noqa: E402
from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.nn import LinearUnit as JaxLinearUnit  # noqa: E402
from mpa_tpu.ops.gather import index_points as jax_index_points  # noqa: E402
from mpa_tpu.ops.pallas.attention_pallas import _bwd_scatter_xla  # noqa: E402
from mpa_tpu.ops.pallas.attention_pallas import transition_attention as jax_attention  # noqa: E402
from mpa_tpu.train import metrics as jax_metrics  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS  # noqa: E402
from mpa_tpu_torch.data import synthetic_clouds  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier  # noqa: E402
from mpa_tpu_torch.nn import LinearUnit  # noqa: E402
from mpa_tpu_torch.ops import index_points, transition_attention  # noqa: E402
from mpa_tpu_torch.ops.attention import attention_bwd_plain, attention_plain  # noqa: E402
from mpa_tpu_torch.ops.gather import gather_plain, scatter_add_plain  # noqa: E402
from mpa_tpu_torch.train import (  # noqa: E402
    class_average_accuracy,
    cls_loss,
    cosine_schedule,
    create_train_state,
    instance_accuracy,
    make_cls_train_step,
    make_optimizer,
    make_train_step,
    smooth_cls_loss,
    step_decay_schedule,
)
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402

CPU = torch.device("cpu")


def _params_of(model):
    return {n: p for n, p in model.named_parameters()}


# -- BatchNorm train mode --------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 10, 6), (8, 6)])
def test_batchnorm_train_mode_matches_flax(shape):
    x = 3.0 * _x(0, shape) + 1.0
    x2 = _x(1, shape)
    jm = JaxLinearUnit(12)
    flat = jax_variables(jm, jnp.asarray(x))
    want, upd = jm.apply(_nest(flat), jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm, _ = port(LinearUnit(shape[-1], 12), flat)
    tm.train()
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # Running statistics: momentum 0.9 and the BIASED batch variance.
    stats = upd["batch_stats"]["norm"]
    np.testing.assert_allclose(tm.norm.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.norm.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)
    # Eval mode after the update reads the updated statistics.
    variables = {"params": _nest(flat)["params"], "batch_stats": upd["batch_stats"]}
    want2 = jm.apply(variables, jnp.asarray(x2), train=False)
    tm.eval()
    with torch.no_grad():
        got2 = tm(torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got2, np.asarray(want2), rtol=1e-5, atol=1e-5)


# -- op gradients -----------------------------------------------------------------


@pytest.mark.parametrize("idx_shape", [(2, 60), (2, 12, 8)])
def test_index_points_grad_matches_jax(idx_shape):
    N, C = 20, 7
    pts = _x(2, (2, N, C))
    idx = np.random.default_rng(3).integers(0, N, idx_shape).astype(np.int32)
    idx.reshape(2, -1)[:, :4] = 5  # duplicate indices: their gradients add up
    w = _x(4, idx_shape + (C,))
    want = jax.grad(lambda p: jnp.sum(jax_index_points(p, jnp.asarray(idx)) * w))(jnp.asarray(pts))
    p = torch.from_numpy(pts).requires_grad_(True)
    (index_points(p, torch.from_numpy(idx)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = scatter_add_plain(torch.from_numpy(w).reshape(2, -1, C),
                            torch.from_numpy(idx).reshape(2, -1), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _attention_case(n_branches, with_shift, seed=7):
    """Inputs with a tie at the maximum, duplicate indices and a query whose
    neighbours all have E = 0 (denominator below the eps floor)."""
    B, N, S, K, c = 2, 40, 24, 8, 16
    rng = np.random.default_rng(seed)
    packed = rng.standard_normal((B, N, n_branches * 2 * c)).astype(np.float32)
    for r in range(n_branches):
        e = slice(2 * r * c, (2 * r + 1) * c)
        packed[..., e] = np.exp(packed[..., e])
        packed[:, 30:, e] = 0.0  # nodes 30.. have E = 0
    packed[:, 1] = packed[:, 0]  # node 1 duplicates node 0: equal w, a tie
    idx = rng.integers(0, 30, (B, S, K)).astype(np.int32)
    idx[:, 0, :2] = (0, 1)
    idx[:, 1] = 30 + np.arange(K) % 10  # every neighbour has E = 0: eps floor
    idx[:, 2] = 5  # one node K times: all K tie at the maximum
    shifts = rng.standard_normal((B, S, n_branches * c)).astype(np.float32) if with_shift else None
    g = rng.standard_normal((B, S, n_branches * c)).astype(np.float32)
    return packed, idx, shifts, g, c


@pytest.mark.parametrize("n_branches", [1, 2])
@pytest.mark.parametrize("with_shift", [False, True])
def test_transition_attention_grad_matches_jax(n_branches, with_shift):
    """The port's CPU gradient (torch autograd of the plain forward) and
    :func:`attention_bwd_plain` against ``mpa_tpu``'s custom-VJP math
    (``_bwd_scatter_xla``, ``_attn_math`` with ``g``) everywhere, and against
    ``jax.grad`` of the CPU reference wherever that is finite: on the
    eps-floored row ``jax.grad`` differentiates ``E / maximum(denom, eps)``
    through ``0 / eps**2``, which flushes to ``0 / 0`` on the CPU, the NaN
    that ``_attn_math``'s ``where`` exists to avoid."""
    packed, idx, shifts, g, c = _attention_case(n_branches, with_shift)
    B, S, K = idx.shape
    G = np.take_along_axis(packed, idx.reshape(B, S * K)[..., None], 1).reshape(B, S, K, -1)
    want_p, want_s = _bwd_scatter_xla(jnp.asarray(G), None if shifts is None else jnp.asarray(shifts),
                                      jnp.asarray(g), jnp.asarray(idx), packed.shape[1],
                                      n_branches, c)
    want_p = np.asarray(want_p)
    assert np.isfinite(want_p).all() and np.abs(want_p).max() > 1e15  # the floored row

    def jloss(p, s):
        return jnp.sum(jax_attention(p, jnp.asarray(idx), s, n_branches, c) * g)

    if with_shift:
        auto_p, auto_s = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(packed), jnp.asarray(shifts))
        np.testing.assert_allclose(np.asarray(auto_s), np.asarray(want_s), rtol=1e-5, atol=1e-6)
    else:
        auto_p = jax.grad(lambda p: jloss(p, None))(jnp.asarray(packed))
    auto_p = np.asarray(auto_p)
    finite = np.isfinite(auto_p)
    floored = np.zeros_like(finite)
    for r in range(n_branches):
        floored[:, 30:, 2 * r * c:(2 * r + 1) * c] = True
    assert not (~finite & ~floored).any()

    tp = torch.from_numpy(packed).requires_grad_(True)
    ts = None if shifts is None else torch.from_numpy(shifts).requires_grad_(True)
    out = transition_attention(tp, torch.from_numpy(idx), ts, n_branches, c)
    (out * torch.from_numpy(g)).sum().backward()
    dpacked, dshift = attention_bwd_plain(torch.from_numpy(packed), torch.from_numpy(idx),
                                          None if shifts is None else torch.from_numpy(shifts),
                                          torch.from_numpy(g), n_branches, c)
    # Relative where the eps floor makes gradients near 1e20, absolute near 1.
    for got in (tp.grad.numpy(), dpacked.numpy()):
        np.testing.assert_allclose(got, want_p, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[finite], auto_p[finite], rtol=1e-5, atol=1e-6)
    if with_shift:
        for got in (ts.grad.numpy(), dshift.numpy()):
            np.testing.assert_allclose(got, np.asarray(want_s), rtol=1e-5, atol=1e-6)
    else:
        assert dshift is None and want_s is None


@pytest.mark.parametrize("n_branches,with_shift,K", [(1, True, 8), (2, False, 5), (1, False, 16)])
def test_attention_bwd_plain_matches_autograd(n_branches, with_shift, K):
    B, N, S, c = 2, 50, 30, 12
    gen = torch.Generator().manual_seed(K)
    packed = torch.randn((B, N, n_branches * 2 * c), generator=gen)
    for r in range(n_branches):
        packed[..., 2 * r * c:(2 * r + 1) * c] = packed[..., 2 * r * c:(2 * r + 1) * c].exp()
    idx = torch.randint(0, N, (B, S, K), generator=gen, dtype=torch.int32)
    shifts = torch.randn((B, S, n_branches * c), generator=gen) if with_shift else None
    g = torch.randn((B, S, n_branches * c), generator=gen)
    inputs = [packed.requires_grad_(True)] + ([shifts.requires_grad_(True)] if with_shift else [])
    out = attention_plain(packed, idx, shifts, n_branches, c)
    want = torch.autograd.grad(out, inputs, g)
    dpacked, dshift = attention_bwd_plain(packed.detach(), idx,
                                          None if shifts is None else shifts.detach(),
                                          g, n_branches, c)
    torch.testing.assert_close(dpacked, want[0], rtol=1e-5, atol=1e-6)
    if with_shift:
        torch.testing.assert_close(dshift, want[1], rtol=1e-5, atol=1e-6)


def test_scatter_add_plain_matches_autograd_and_drops_out_of_range():
    B, N, E, W = 2, 30, 90, 5
    gen = torch.Generator().manual_seed(0)
    pts = torch.randn((B, N, W), generator=gen, requires_grad=True)
    idx = torch.randint(0, N, (B, E), generator=gen, dtype=torch.int32)
    g = torch.randn((B, E, W), generator=gen)
    (want,) = torch.autograd.grad(gather_plain(pts, idx), pts, g)
    torch.testing.assert_close(scatter_add_plain(g, idx, N), want, rtol=1e-5, atol=1e-6)
    bad = idx.clone()
    bad[:, :10] = N + 3  # out of range: dropped, as in scatter_add_rmw
    bad[:, 10:20] = -1
    kept = torch.autograd.grad(gather_plain(pts, idx[:, 20:]), pts, g[:, 20:])[0]
    torch.testing.assert_close(scatter_add_plain(g, bad, N), kept, rtol=1e-5, atol=1e-6)


# -- the whole classifier -----------------------------------------------------------

LADDER = (128, 64, 32, 16, 8)  # the frozen oracles' ladder for 256-point clouds


def _oracle_model(fixture, dropout=0.0):
    variables = {k: v for k, v in fixture.items() if k.startswith("variables/")}
    model, unused = port(MarkovClassifier(num_classes=15, npoints=LADDER, dropout=dropout),
                         variables)
    return model, unused


def test_cls_eval_grads_match_frozen_oracle():
    """Eval-mode gradients of a mean NLL with respect to every parameter and
    the input cloud, against ``cls_grads.npz`` at atol 1e-4, rtol 1e-3 (the
    bounds of ``test_grad_parity.py``)."""
    fwd = oracle("cls_model_forward", lambda: pytest.fail("fixture cls_model_forward.npz missing"))
    f = oracle("cls_grads", lambda: pytest.fail("fixture cls_grads.npz missing"))
    model, _ = _oracle_model(fwd)
    x = torch.from_numpy(f["x"]).requires_grad_(True)
    labels = torch.from_numpy(f["labels"].astype(np.int64))
    loss = cls_loss(model(x), labels)
    loss.backward()
    assert abs(float(loss.detach()) - float(f["loss"])) < 5e-5
    want_flat = {"params/" + k[len("want_params/"):]: v
                 for k, v in f.items() if k.startswith("want_params/")}
    want, unused = from_jax_variables(want_flat, model)
    # Leaves only the reference checkpoint carries: no gradient reaches them.
    assert unused and all(np.abs(want_flat[k]).max() == 0.0 for k in unused)
    params = _params_of(model)
    assert set(want) == set(params) and len(params) > 50
    for name, p in params.items():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=f"grad mismatch at {name}")
    np.testing.assert_allclose(x.grad.numpy(), f["want_x"], atol=1e-4, rtol=1e-3)


def _jax_state_to_port(state, model):
    flat = {}
    for coll, tree in (("params", state.params), ("batch_stats", state.batch_stats)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([coll] + [p.key for p in path])] = np.asarray(leaf)
    converted, unused = from_jax_variables(flat, model)
    assert unused == []
    return converted


def test_adam_steps_match_mpa_tpu():
    """Two ``adam-l2`` steps (lr 1e-3, wd 1e-4, smoothing 0.1, dropout 0)
    from the same weights on the same batches: the loss of each step, every
    updated parameter (the ``q`` layers included, which only weight decay
    moves) and the running statistics (the biased variance).

    Tolerances. Losses: 1e-5. Parameters and running statistics: 1e-5 for
    all but 0.1% of the entries, and every entry within ``2 * lr * steps``.
    Adam divides a gradient by its own size, so where a gradient is zero up
    to rounding its step is ``lr`` times a sign that rounding picks; two
    float32 runs may then differ by up to ``2 * lr`` a step there. That is
    the case for single entries anywhere, for every Dense bias that feeds a
    train-mode BatchNorm (the batch mean removes its gradient) and for the
    ``k`` biases (a shift of all attention logits cancels in their
    normalisation), so those biases are held to the bound only, and the
    running means of the BatchNorms fed through such a bias, which take
    (1 - 0.9) of the next batch's mean, to a tenth of it. The ``q`` layers see the same zero gradient plus decay on
    both sides: 1e-6. B = 16, because at B = 4 the train-mode gradient is
    ill-conditioned (a 1e-7 change of the input moves it by 1e-4 relative).
    """
    B, N, spe, lr, steps = 16, 128, 8, 1e-3, 2
    xs = [_x(20 + i, (B, N, 3)) for i in range(steps)]
    ys = [np.random.default_rng(30 + i).integers(0, 15, B) for i in range(steps)]
    jm = JaxMarkovClassifier(num_classes=15, dropout=0.0, **SMALL)
    flat = jax_variables(jm, jnp.asarray(xs[0]))
    nested = _nest(flat)

    sched = jtr.step_decay_schedule(lr, 20, 0.7)
    tx = jtr.make_optimizer("adam-l2", lambda step: sched(step // spe), 1e-4)
    jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"], tx=tx,
                                   batch_stats=nested["batch_stats"])
    jstep = jax.jit(jtr.make_train_step(lambda out, y: jtr.smooth_cls_loss(out, y, 0.1)))
    jlosses = []
    for x, y in zip(xs, ys):
        jstate, loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
        jlosses.append(float(loss))

    model, _ = port(MarkovClassifier(num_classes=15, dropout=0.0, **SMALL), flat)
    q_before = model.keep_high.la1.feature_trans.q.weight.detach().clone()
    cfg = PRESETS["scanobjectnn_cls"]
    assert (cfg.optimizer, cfg.learning_rate, cfg.weight_decay) == ("adam-l2", lr, 1e-4)
    state = create_train_state(model, cfg, CPU)
    step = make_cls_train_step(cfg, spe)
    losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))) for x, y in zip(xs, ys)]
    assert state.step == steps
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)

    want = _jax_state_to_port(jstate, model)
    got = model.state_dict()
    assert not torch.equal(got["keep_high.la1.feature_trans.q.weight"], q_before)
    noise_driven = {n for n in got if n.endswith((".linear.bias", ".k.bias"))}
    noise_driven |= {"fc1.bias", "fc2.bias", "keep_high.final_class.bias"}
    off = total = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = (got[name] - w).abs()
        bound = 2 * lr * steps * (0.1 if name.endswith("running_mean") else 1.0)
        assert float(diff.max()) <= bound, f"after {steps} steps: {name} off by {float(diff.max())}"
        if ".q." in name:
            assert float(diff.max()) <= 1e-6, name
        if name not in noise_driven and not name.endswith("running_mean"):
            off += int((diff > 1e-5).sum())
            total += diff.numel()
    assert total > 200_000 and off <= 1e-3 * total, f"{off} of {total} entries off by > 1e-5"


def test_sgd_curve_tracks_frozen_torch_curve():
    """25 SGD steps (lr 2e-3, no momentum, plain NLL, dropout 0) from the
    frozen curve's weights on its batches, with the criteria of
    ``test_training_equivalence.py``."""
    f = oracle("cls_train_curve", lambda: pytest.fail("fixture cls_train_curve.npz missing"))
    want = f["want"]
    steps, lr, batch = len(want), 2e-3, 8
    r = np.random.default_rng(0)
    xs = r.normal(size=(2, batch, 256, 3)).astype(np.float32)
    ys = r.integers(0, 15, size=(2, batch))
    model, _ = _oracle_model(f)
    state = create_train_state(model, PRESETS["scanobjectnn_cls"].with_overrides(
        optimizer="sgd", learning_rate=lr, weight_decay=0.0, momentum=0.0), CPU)
    step = make_train_step(cls_loss, lambda epoch: lr, steps)
    got = np.asarray([float(step(state, torch.from_numpy(xs[i % 2]), torch.from_numpy(ys[i % 2])))
                      for i in range(steps)])
    diff = np.abs(got - want)
    assert diff[0] < 1e-4, f"step-0 loss mismatch: {got[0]} vs {want[0]}"
    assert diff[1] < 0.03, f"step-1 loss mismatch (first update): {diff[1]}"
    assert float(diff.mean()) < 0.25, f"curves diverge on average: {diff.round(4).tolist()}"
    assert float(diff.max()) < 0.5, f"curve excursion too large: {diff.round(4).tolist()}"
    assert float(diff[-5:].mean()) < 0.2, f"converged plateaus differ: {diff[-5:].round(4).tolist()}"
    assert want[-1] < want[0] - 0.2
    assert got[-1] < got[0] - 0.2
    assert abs((want[0] - want[-1]) - (got[0] - got[-1])) < 0.1


# -- dropout, losses, schedules, metrics, data -----------------------------------------


def test_dropout_draws_from_the_callers_generator():
    x = torch.from_numpy(_x(40, (4, 128, 3)))
    model = MarkovClassifier(num_classes=15, dropout=0.5, **SMALL).train()
    with pytest.raises(ValueError, match="Generator"):
        model(x)
    a = model(x, generator=torch.Generator().manual_seed(1))
    b = model(x, generator=torch.Generator().manual_seed(1))
    c = model(x, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    model.eval()
    with torch.no_grad():  # eval mode: no dropout, no generator needed
        torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)


def test_cls_losses_match_mpa_tpu():
    logp = torch.log_softmax(torch.from_numpy(_x(41, (6, 15))), -1)
    y = np.random.default_rng(42).integers(0, 15, 6)
    for smoothing in (0.0, 0.1, 0.3):
        want = jtr.smooth_cls_loss(jnp.asarray(logp.numpy()), jnp.asarray(y), smoothing)
        got = smooth_cls_loss(logp, torch.from_numpy(y), smoothing)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = jtr.cls_loss(jnp.asarray(logp.numpy()), jnp.asarray(y))
    np.testing.assert_allclose(float(cls_loss(logp, torch.from_numpy(y))), float(want), rtol=1e-6)


@pytest.mark.parametrize("epoch", [0, 1, 19, 20, 59, 299, 400])
def test_schedules_match_mpa_tpu(epoch):
    for offset in (0, 1):
        want = jtr.step_decay_schedule(1e-3, 20, 0.7, epoch_offset=offset)(epoch)
        got = step_decay_schedule(1e-3, 20, 0.7, epoch_offset=offset)(epoch)
        np.testing.assert_allclose(got, float(want), rtol=1e-6)
    want = jtr.cosine_schedule(0.1, 300, 1e-3)(epoch)
    np.testing.assert_allclose(cosine_schedule(0.1, 300, 1e-3)(epoch), float(want), rtol=1e-6)


def test_metrics_and_synthetic_clouds_match_mpa_tpu():
    pts, labels = synthetic_clouds(40, 64, 15, seed=3)
    jpts, jlabels = jax_synthetic_clouds(40, 64, 15, seed=3)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(labels, jlabels)
    pred = np.random.default_rng(4).integers(0, 15, 40)
    assert instance_accuracy(pred, labels) == jax_metrics.instance_accuracy(pred, labels)
    assert class_average_accuracy(pred, labels, 15) == jax_metrics.class_average_accuracy(
        pred, labels, 15)


def test_optimizer_kinds():
    w = torch.nn.Parameter(torch.ones(3))
    adam = make_optimizer("adam-l2", [w], 1e-3, 1e-4)
    assert isinstance(adam, torch.optim.Adam) and adam.defaults["weight_decay"] == 1e-4
    assert adam.defaults["betas"] == (0.9, 0.999) and adam.defaults["eps"] == 1e-8
    sgd = make_optimizer("sgd", [w], 0.1, 1e-4, momentum=0.9)
    assert isinstance(sgd, torch.optim.SGD) and sgd.defaults["dampening"] == 0.0
    with pytest.raises(ValueError):
        make_optimizer("adamw", [w], 1e-3)


# -- the entry point ------------------------------------------------------------------


def test_cli_train_two_steps_on_cpu(capsys):
    kernels.reset_launch_counts()
    out = cli_train.main(["--device", "cpu", "--max_steps", "2", "--batch_size", "8",
                          "--seed", "0"])
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert 0.0 <= out["instance_acc"] <= 1.0 and 0.0 <= out["class_acc"] <= 1.0
    log = capsys.readouterr().out
    assert "step 2 (epoch 0): loss" in log and "clouds/s" in log and "instance acc" in log
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only
