"""Port parity, ``repsurf_ssg_2x`` training, on the CPU.

As in ``tests/test_torch_port_repsurf.py``, ``mpa_tpu`` runs on the CPU and
the port takes its plain ops. Covered: the first step's train-mode
gradients, tensor by tensor, and two ``adam-l2`` steps against ``mpa_tpu``'s
train step, both in float64 (``jax_enable_x64``), with dropout 0 and the
umbrella's normal flips that ``mpa_tpu`` draws from the key it is given; the
port's float32 train-mode gradients against its float64 ones and against
finite differences; the flips' source in train mode; the ``scanobjectnn_2x`` preset and a two-step ``cli.train --preset
scanobjectnn_2x``. The eval-mode gradients are in
``tests/test_torch_port_repsurf_grads.py``.

The clouds are scaled to 0.2x, as ``tests/test_train.py``'s repsurf test
scales them, so a ball holds real neighbours: at unit scale most balls
backfill to 24 copies of their centre and the grouped train-mode BatchNorm
turns rounding differences into large ones.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import _nest, jax_variables, port  # noqa: E402
from test_torch_port_repsurf import SMALL, _t, _x  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.models.repsurf_ssg_2x import RepSurfSSG2x as JaxRepSurf  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS, model_kwargs  # noqa: E402
from mpa_tpu_torch.models import RepSurfSSG2x  # noqa: E402
from mpa_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_cls_train_step,
    smooth_cls_loss,
)
from mpa_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from mpa_tpu_torch.utils.init import init_like_flax  # noqa: E402

CPU = torch.device("cpu")


def _flips(key, B):
    """The signs ``cal_normal`` draws from ``key``, under the current
    ``jax_enable_x64`` (it changes ``randint``'s default dtype, and so the
    bits drawn)."""
    return np.asarray(jax.random.randint(key, (B,), 0, 2)).astype(np.float64) * 2.0 - 1.0


def _flat(tree, collection):
    return {"/".join([collection] + [p.key for p in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference64():
    """``mpa_tpu``'s repsurf in float64 (``jax_enable_x64``) at ``SMALL``,
    dropout 0, on two batches of 0.2x clouds: the flax variables it starts
    from (float32), the umbrella flips it draws from its key (one key, so the
    same flips at both steps), the gradients of the first step's loss, and
    two steps of its ``adam-l2`` train step as ``make_train_step`` builds it
    (the ``scanobjectnn_2x`` recipe: lr 1e-3, wd 1e-4, smoothing 0.1).

    It runs eagerly, as ``make_train_step`` returns it. Under ``jax.jit`` the
    same float64 loss comes out within 2e-14 but its gradients part from
    these by up to 89% in a tensor (``sa2/mlps/bn0/bias``), so ``mpa_tpu``'s
    jitted train-mode gradients of this model are not the reference."""
    B, spe, lr, steps = 8, 8, 1e-3, 2
    xs = [_x(22 + i, (B, 128, 3), scale=0.2) for i in range(steps)]
    ys = [np.random.default_rng(30 + i).integers(0, 15, B) for i in range(steps)]
    key = jax.random.key(5)
    jm = JaxRepSurf(num_classes=15, dropout=0.0, **SMALL)
    flat = jax_variables(jm, jnp.asarray(xs[0]))
    with jax.enable_x64(True):
        flips = _flips(key, B)
        nested = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(flat))
        loss_fn = lambda out, y: jtr.smooth_cls_loss(out, y, 0.1)  # noqa: E731

        def first_loss(params):
            out, _ = jm.apply({"params": params, "batch_stats": nested["batch_stats"]},
                              jnp.asarray(xs[0], jnp.float64), train=True, rng=key,
                              rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
            return loss_fn(out, jnp.asarray(ys[0]))

        grads = _flat(jax.grad(first_loss)(nested["params"]), "params")
        sched = jtr.step_decay_schedule(lr, 20, 0.7)
        tx = jtr.make_optimizer("adam-l2", lambda step: sched(step // spe), 1e-4)
        jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"], tx=tx,
                                       batch_stats=nested["batch_stats"])
        jstep = jtr.make_train_step(loss_fn, model_kwargs={"rng": key})
        losses = []
        for x, y in zip(xs, ys):
            jstate, loss = jstep(jstate, jnp.asarray(x, jnp.float64), jnp.asarray(y),
                                 jax.random.key(0))
            losses.append(float(loss))
        final = {**_flat(jstate.params, "params"), **_flat(jstate.batch_stats, "batch_stats")}
    assert (flips == 1).any() and (flips == -1).any()
    return dict(xs=xs, ys=ys, flips=torch.from_numpy(flips), flat=flat, grads=grads,
                losses=losses, final=final, spe=spe, lr=lr)


def _port64(ref):
    """The port's repsurf from ``ref``'s variables, in float64, handed
    ``ref``'s flips at every forward."""
    model, _ = port(RepSurfSSG2x(num_classes=15, dropout=0.0, **SMALL), ref["flat"])
    model.register_forward_pre_hook(
        lambda m, args, kw: (args, dict(kw, flips=ref["flips"])), with_kwargs=True)
    return model.double()


def test_repsurf_train_gradients_match_mpa_tpu_in_float64(reference64):
    """The first step's train-mode gradients, tensor by tensor, against
    ``mpa_tpu``'s in float64. In float32 neither side's train-mode gradients
    are sharp enough to hold against the other (the grouped BatchNorm's
    backward takes means of terms that cancel almost to nothing); in float64
    both are, and the port's float32 gradients are held to its float64 ones
    by ``test_repsurf_train_gradients_match_float64_and_finite_differences``.

    Held: each tensor's gradient within 1e-9 of its own norm plus 1e-12 of
    the whole gradient's norm (read: 1.9e-13 of its own norm at worst). The
    floor is for the biases ahead of a train-mode BatchNorm, whose gradients
    are zero up to rounding, 1e-17 to 1e-13 on both sides against a whole
    gradient of norm 23."""
    ref = reference64
    model = _port64(ref).train()
    loss = smooth_cls_loss(model(_t(ref["xs"][0]).double()), torch.from_numpy(ref["ys"][0]), 0.1)
    loss.backward()
    want, unused = from_jax_variables(ref["grads"], model)
    assert unused == [] and all(w.dtype == torch.float64 for w in want.values())
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    total = float(torch.sqrt(sum((w ** 2).sum() for w in want.values())))
    worst = 0.0
    for name, w in want.items():
        err = float((params[name].grad - w).norm())
        assert err <= 1e-9 * float(w.norm()) + 1e-12 * total, (
            f"{name}: gradient off mpa_tpu's by {err:.3e} (norm {float(w.norm()):.3e})")
        if float(w.norm()) > 1e-6 * total:
            worst = max(worst, err / float(w.norm()))
    assert worst < 1e-9


def test_repsurf_adam_steps_match_mpa_tpu(reference64):
    """Two ``adam-l2`` steps of the ``scanobjectnn_2x`` recipe (lr 1e-3, wd
    1e-4, smoothing 0.1, dropout 0) from the same weights on the same
    batches, against ``mpa_tpu``'s train step, both in float64, with the
    umbrella's flips that ``mpa_tpu`` draws from the key it is given.

    Float64, because in float32 neither side's train-mode gradients are sharp
    enough (``test_repsurf_train_gradients_match_mpa_tpu_in_float64``), and
    Adam's first step moves each entry by ``lr`` times the sign of its
    gradient: two float32 runs part by up to ``2 * lr`` a step wherever a
    gradient is noise, which no useful limit can tell from a wrong gradient.

    Held: the loss of each step within 1e-8 (read: 3.5e-14, and 1.0e-9 at
    the second step: ``mpa_tpu``'s schedule gives the rate as a float32,
    4.7e-8 above 1e-3); every parameter within 1e-7 (``2 * lr * steps`` is
    4e-3; read: 2.5e-9, where a gradient that is zero up to rounding moves
    its entry by about ``lr * 1e-6``); every running statistic within 1e-7
    of the larger of 1 and its size (read: 1.4e-9).
    """
    ref = reference64
    model = _port64(ref)
    cfg = PRESETS["scanobjectnn_2x"]
    assert (cfg.optimizer, cfg.learning_rate, cfg.weight_decay) == ("adam-l2", ref["lr"], 1e-4)
    state = create_train_state(model, cfg, CPU)
    step = make_cls_train_step(cfg, ref["spe"])
    losses = [float(step(state, _t(x).double(), torch.from_numpy(y)))
              for x, y in zip(ref["xs"], ref["ys"])]
    assert state.step == 2
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-8)

    want, unused = from_jax_variables(ref["final"], model)
    assert unused == []
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = got[name] - w
        if "running" in name:
            diff = diff / w.abs().clamp_min(1.0)
        worst = float(diff.abs().max())
        assert worst <= 1e-7, f"after 2 steps: {name} off by {worst}"


def _loss64(model, x, y, flips):
    return smooth_cls_loss(model(x, flips=flips), y, 0.1)


def test_repsurf_train_gradients_match_float64_and_finite_differences():
    """The port's train-mode gradients (dropout 0, given flips) are the
    gradients of its loss: in float32 within 2e-3 of float64 (relative, per
    tensor; read: 7e-4), and in float64 equal to a central finite difference
    of the loss along a random direction in the whole parameter space
    (step 1e-7) within 1e-6 relative (read: 3.2e-10; a ReLU or a max that
    switches inside the step would part them). The biases that feed a
    train-mode BatchNorm, whose gradients are zero up to rounding, are left
    out of the per-tensor check and not out of the directional one."""
    B = 8
    x, y = _x(22, (B, 128, 3), scale=0.2), torch.from_numpy(np.random.default_rng(30).integers(0, 15, B))
    flips = torch.tensor([1.0, -1.0] * (B // 2))
    base = init_like_flax(RepSurfSSG2x(num_classes=15, dropout=0.0, **SMALL),
                          torch.Generator().manual_seed(0)).train()
    grads = {}
    for dt in (torch.float32, torch.float64):
        m = copy.deepcopy(base).to(dt)
        _loss64(m, _t(x).to(dt), y, flips.to(dt)).backward()
        grads[dt] = {n: p.grad.double() for n, p in m.named_parameters()}
    g32, g64 = grads[torch.float32], grads[torch.float64]
    zero_up_to_rounding = ("mlp_l0.bias", "mlp_f0.bias", "mlp1.bias", "mlp2.bias", "fc1.bias",
                           "fc2.bias", "sa4.mlps.bn1.bias")
    checked = 0
    for name in g64:
        if name.endswith(zero_up_to_rounding) or (".conv" in name and name.endswith(".bias")):
            continue
        rel = float((g32[name] - g64[name]).norm() / g64[name].norm())
        assert rel < 2e-3, f"{name}: float32 gradient off float64 by {rel:.2e}"
        checked += 1
    assert checked > 40

    m = copy.deepcopy(base).double()
    params = dict(m.named_parameters())
    gen = torch.Generator().manual_seed(1)
    direction = {n: torch.randn(p.shape, generator=gen, dtype=torch.float64) for n, p in params.items()}
    h = 1e-7

    def loss_at(sign):
        with torch.no_grad():
            for n, p in params.items():
                p.add_(sign * h * direction[n])
            out = float(_loss64(m, _t(x).double(), y, flips.double()))
            for n, p in params.items():
                p.sub_(sign * h * direction[n])
        return out

    fd = (loss_at(1.0) - loss_at(-1.0)) / (2 * h)
    analytic = float(sum((g64[n] * direction[n]).sum() for n in params))
    assert abs(fd - analytic) <= 1e-6 * abs(analytic), (fd, analytic)


def test_scanobjectnn_2x_preset():
    cfg = PRESETS["scanobjectnn_2x"]
    assert (cfg.task, cfg.model, cfg.num_classes, cfg.num_points, cfg.batch_size) == (
        "cls", "repsurf_ssg_2x", 15, 1024, 64)
    assert (cfg.scheduler, cfg.decay_step, cfg.decay_gamma, cfg.epochs, cfg.seed) == (
        "step", 20, 0.7, 250, 2800)
    assert model_kwargs(cfg) == {"num_classes": 15}


def test_train_mode_needs_flips_or_a_generator():
    x = _t(_x(40, (2, 128, 3), scale=0.2))
    model = RepSurfSSG2x(num_classes=15, dropout=0.0, **SMALL).train()
    with pytest.raises(ValueError, match="flips or a torch.Generator"):
        model(x)
    a = model(x, generator=torch.Generator().manual_seed(1))
    b = model(x, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = model(x, flips=torch.tensor([1.0, -1.0]))  # dropout 0: no generator needed
    assert c.shape == (2, 15) and torch.isfinite(c).all()


def test_cli_train_scanobjectnn_2x_two_steps_on_cpu(capsys):
    kernels.reset_launch_counts()
    out = cli_train.main(["--preset", "scanobjectnn_2x", "--device", "cpu", "--max_steps", "2",
                          "--batch_size", "2", "--train_clouds", "8", "--eval_clouds", "4",
                          "--seed", "0"])
    assert out["steps"] == 2 and len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["instance_acc"] <= 1.0
    log = capsys.readouterr().out
    assert "model repsurf_ssg_2x" in log and "step 2 (epoch 0): loss" in log
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only
