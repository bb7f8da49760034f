"""Port parity, ``markov_pose`` and ``markov_completion`` on the CPU:
``rotation_6d_to_matrix`` and ``rotation_geodesic_loss`` (values and
gradients, float64 and float32, an exact identity pair at the clip), both
models' eval forward, their eval-mode gradients and two ``adam-l2`` steps
against ``mpa_tpu``'s train step, ``chamfer_distance`` and ``completion_loss`` (float32 and float64,
with gradients), the folding grid, ``realistic_clouds(canonical_pose=True)``,
the pose and completion arrays and ``load_dataset`` bit for bit, the eval
metrics as the mean of batch means on a ragged split, the serving loaders,
and two-step ``cli.train`` runs of ``pose_modelnet40`` and ``completion`` on
synthetic clouds and on a ModelNet40 text tree the test writes.

``mpa_tpu`` runs as its own tests run it (JAX on the CPU, jitted); the port
takes its plain ops. Tolerances, each given at its test: float64
comparisons within 1e-12 (``jnp.cross`` is one of the products XLA
contracts into FMAs on the CPU, so float32 differs in the last bits:
float32 within 1e-6); rotations and clouds within 1e-5; the adam steps as
``test_torch_port_train.py`` holds cls's, but completion's second step
(see its test).
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import _flat, _nest, port  # noqa: E402
from test_torch_port_train import _jax_state_to_port, _params_of  # noqa: E402

import mpa_tpu.cli.train as jax_cli_train  # noqa: E402
from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.configs.presets import PRESETS as JAX_PRESETS  # noqa: E402
from mpa_tpu.data import realistic_clouds as jax_realistic_clouds  # noqa: E402
from mpa_tpu.models import MarkovCompletion as JaxMarkovCompletion  # noqa: E402
from mpa_tpu.models import MarkovPose as JaxMarkovPose  # noqa: E402
from mpa_tpu.models import rotation_6d_to_matrix as jax_rotation_6d_to_matrix  # noqa: E402
from mpa_tpu.models import rotation_geodesic_loss as jax_geodesic  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS, model_kwargs  # noqa: E402
from mpa_tpu_torch.data import realistic_clouds, surface_clouds  # noqa: E402
from mpa_tpu_torch.models import (  # noqa: E402
    MarkovCompletion,
    MarkovPose,
    get_model,
    rotation_6d_to_matrix,
    rotation_geodesic_loss,
)
from mpa_tpu_torch.models.markov_completion import fold_grid  # noqa: E402
from mpa_tpu_torch.serve import load_completer, load_pose_regressor  # noqa: E402
from mpa_tpu_torch.train import (  # noqa: E402
    TRAIN_STEPS,
    chamfer_distance,
    completion_loss,
    create_train_state,
)
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402
from mpa_tpu_torch.utils.init import init_like_flax  # noqa: E402

CPU = torch.device("cpu")
ENCODER = dict(npoints=(64, 32, 16, 8, 4), channels=(16, 16, 16, 32, 32, 64),
               encoder_features=64)
N = 128


def jax_variables(module, *args, seed=0):
    """``test_torch_port_cls.jax_variables`` with the init jitted (flax's
    eager init of a Markov model dispatches every op alone and takes 25 s):
    every BatchNorm scale, bias and statistic and every Dense bias
    randomised, so the normalisation path is exercised in eval mode."""
    variables = jax.jit(lambda key, *a: module.init(key, *a, train=False))(
        jax.random.key(seed), *args)
    rng = np.random.default_rng(seed)
    flat = _flat(jax.tree_util.tree_map(np.asarray, dict(variables)))
    for key, v in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            flat[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[key] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return flat


def _x(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# -- rotations ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_rotation_6d_to_matrix_matches_mpa_tpu(dtype, atol):
    """Values and the gradient of a weighted sum, on 64 random 6D vectors
    and on degenerate ones (a zero first vector, parallel vectors: the 1e-8
    norm floors). The values agree on all of them; the gradients on the
    proper ones only: at a zero norm ``jnp.linalg.norm``'s gradient is NaN,
    torch's ``vector_norm``'s 0, so ``mpa_tpu``'s gradient there is NaN and
    the port's finite."""
    x6 = _x(0, (64, 6), dtype)
    x6[0, :3] = 0.0
    x6[1, 3:] = 2.0 * x6[1, :3]
    w = _x(1, (64, 3, 3), dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_rotation_6d_to_matrix(jnp.asarray(x6)))
        want_grad = np.asarray(jax.grad(lambda a: jnp.sum(jax_rotation_6d_to_matrix(a)
                                                          * jnp.asarray(w)))(jnp.asarray(x6)))
    t = torch.from_numpy(x6).requires_grad_(True)
    got = rotation_6d_to_matrix(t)
    (got * torch.from_numpy(w)).sum().backward()
    assert got.dtype == t.dtype
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(t.grad.numpy()[2:], want_grad[2:], rtol=0, atol=atol * 10)
    assert np.isnan(want_grad[:2]).any() and np.isfinite(t.grad.numpy()).all()
    m = got.detach().numpy()[2:]  # proper rotations
    np.testing.assert_allclose(m @ m.transpose(0, 2, 1), np.broadcast_to(np.eye(3), m.shape),
                               atol=100 * atol)
    np.testing.assert_allclose(np.linalg.det(m), 1.0, atol=100 * atol)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_rotation_geodesic_loss_matches_mpa_tpu(dtype, atol):
    """The mean angle and its gradient, on a batch that holds an exact
    identity pair (``pred == target``: the cosine clipped at 1 - 1e-7, no
    gradient through the clip) and an exact half-turn pair."""
    pred = rotation_6d_to_matrix(torch.from_numpy(_x(2, (16, 6), dtype))).numpy()
    target = rotation_6d_to_matrix(torch.from_numpy(_x(3, (16, 6), dtype))).numpy()
    target[0] = pred[0]
    target[1] = pred[1] @ np.diag([-1.0, -1.0, 1.0]).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        want, want_grad = jax.value_and_grad(jax_geodesic)(jnp.asarray(pred), jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = rotation_geodesic_loss(p, torch.from_numpy(target))
    got.backward()
    assert got.dtype == p.dtype
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=atol)
    # arccos' slope 1 / sin(angle) scales the cosine's rounding: float32
    # gradients read 3.9e-5 relative apart at most.
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), atol=atol * 10,
                               rtol=0 if dtype == np.float64 else 1e-4)
    assert not p.grad[0].any() and not p.grad[1].any()  # both pairs at the clip


# -- the models ------------------------------------------------------------------------


def test_markov_pose_matches_mpa_tpu():
    x = _x(4, (2, N, 3))
    jm = JaxMarkovPose(dropout=0.0, **ENCODER)
    flat = jax_variables(jm, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, p: jm.apply(v, p, train=False))(_nest(flat),
                                                                       jnp.asarray(x)))
    tm, unused = port(MarkovPose(dropout=0.0, **ENCODER), flat)
    assert unused == []
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_markov_completion_matches_mpa_tpu():
    """``(coarse, fine)`` within 1e-5; the fine cloud starts with the input
    (``include_input``) and its children sit ``fold3``'s offset away from
    their coarse point."""
    x = _x(5, (2, N, 3))
    kw = dict(num_coarse=32, **ENCODER)
    jm = JaxMarkovCompletion(**kw)
    flat = jax_variables(jm, jnp.asarray(x))
    wc, wf = jax.jit(lambda v, p: jm.apply(v, p, train=False))(_nest(flat), jnp.asarray(x))
    tm, unused = port(MarkovCompletion(**kw), flat)
    assert unused == []
    with torch.inference_mode():
        coarse, fine = tm(torch.from_numpy(x))
    assert tuple(coarse.shape) == (2, 32, 3) and tuple(fine.shape) == (2, N + 32 * 4, 3)
    np.testing.assert_allclose(coarse.numpy(), np.asarray(wc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(fine.numpy(), np.asarray(wf), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(fine.numpy()[:, :N], x)
    with torch.inference_mode():
        bare = MarkovCompletion(include_input=False, **kw)
        bare.load_state_dict(tm.state_dict())
        assert tuple(bare.eval()(torch.from_numpy(x))[1].shape) == (2, 32 * 4, 3)


@pytest.mark.parametrize("task", ["pose", "completion"])
def test_eval_grads_match_mpa_tpu(task):
    """Eval-mode gradients of the task's loss (the geodesic angle to target
    rotations; the coarse and fine Chamfer to the full cloud) with respect
    to every parameter and the input cloud, against ``jax.grad`` on the same
    variables: the loss within 1e-5, every gradient within 1e-4 + 1e-3
    relative (float32 products summed in another order; partseg_fp's
    bounds). Read: the worst entry at 2.2% of its bound for pose (3.9e-6
    off, gradients up to 2.5) and 1.4% for completion."""
    x = _x(6, (2, N, 3))
    if task == "pose":
        y = rotation_6d_to_matrix(torch.from_numpy(_x(7, (2, 6)))).numpy()
        jm, tm = JaxMarkovPose(dropout=0.0, **ENCODER), MarkovPose(dropout=0.0, **ENCODER)
        jloss, tloss = jax_geodesic, rotation_geodesic_loss
    else:
        y = _x(7, (2, 2 * N, 3))
        kw = dict(num_coarse=32, **ENCODER)
        jm, tm = JaxMarkovCompletion(**kw), MarkovCompletion(**kw)
        jloss, tloss = jtr.completion_loss, completion_loss
    flat = jax_variables(jm, jnp.asarray(x))
    stats = _nest(flat)["batch_stats"]

    def loss(params, xx):
        return jloss(jm.apply({"params": params, "batch_stats": stats}, xx, train=False),
                     jnp.asarray(y))

    want_loss, (gparams, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        _nest(flat)["params"], jnp.asarray(x))
    tm, _ = port(tm, flat)
    xt = torch.from_numpy(x).requires_grad_(True)
    got_loss = tloss(tm(xt), torch.from_numpy(y))
    got_loss.backward()
    assert abs(float(got_loss.detach()) - float(want_loss)) <= 1e-5
    want, unused = from_jax_variables(
        {"params/" + "/".join(str(p.key) for p in path): np.asarray(leaf)
         for path, leaf in jax.tree_util.tree_flatten_with_path(gparams)[0]}, tm)
    assert unused == []
    params = _params_of(tm)
    assert set(want) == set(params) and len(params) > 50
    for name, p in params.items():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=f"grad mismatch at {name}")
    assert any(float(p.grad.abs().max()) > 1e-2 for p in params.values() if p.grad is not None)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_fold_grid_is_jnp_linspace(r):
    """Element for element, eager and inside a jitted product (the model's
    use), at every ratio up to the preset's 4."""
    want = np.asarray(jnp.linspace(-0.05, 0.05, r))
    in_jit = np.asarray(jax.jit(lambda a: jnp.linspace(-0.05, 0.05, r)[None, :] * a)(
        jnp.ones((2, r))))[0]
    got = fold_grid(r)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, in_jit)
    np.testing.assert_array_equal(MarkovCompletion(up_ratio=r, **ENCODER).grid.numpy(), want)


def _adam_steps(task, jm, tm, xs, ys, jloss, limits):
    """Adam-l2 steps of ``task``'s preset on both sides from the same
    weights, one a batch; after each step its loss (within
    ``limit["loss"]``) and the whole state: every entry within ``2 * lr *
    steps`` (a tenth of it for running means) and all but 0.1% of the
    entries within ``limit["most"]``, but for the biases whose gradient is
    zero up to rounding (Adam turns their rounding into steps of ``lr``)."""
    cfg = PRESETS["pose_modelnet40" if task == "pose" else "completion"]
    assert (cfg.optimizer, cfg.learning_rate, cfg.weight_decay, cfg.scheduler, cfg.eta_min) == (
        "adam-l2", 1e-3, 1e-4, "cos", 1e-5)
    spe, lr = 8, cfg.learning_rate
    flat = jax_variables(jm, jnp.asarray(xs[0]))
    nested = _nest(flat)
    sched = jtr.cosine_schedule(cfg.learning_rate, cfg.epochs, cfg.eta_min)
    tx = jtr.make_optimizer("adam-l2", lambda step: sched(step // spe), cfg.weight_decay)
    jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"], tx=tx,
                                   batch_stats=nested["batch_stats"])
    jstep = jax.jit(jtr.make_train_step(jloss))
    model, _ = port(tm, flat)
    state = create_train_state(model, cfg, CPU)
    step = TRAIN_STEPS[task](cfg, spe)
    noise_driven = {n for n in model.state_dict() if n.endswith((".linear.bias", ".k.bias"))}
    noise_driven |= {"fc1.bias", "keep_high.final_class.bias"}
    for i, (x, y, limit) in enumerate(zip(xs, ys, limits)):
        jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
        loss = float(step(state, torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(loss - float(jl)) <= limit["loss"], f"step {i}: {loss} vs {float(jl)}"
        want = _jax_state_to_port(jstate, model)
        got = model.state_dict()
        off = total = 0
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            diff = (got[name] - w).abs()
            bound = 2 * lr * (i + 1) * (0.1 if name.endswith("running_mean") else 1.0)
            assert float(diff.max()) <= bound, f"after step {i}: {name} off by {float(diff.max())}"
            if name not in noise_driven and not name.endswith("running_mean"):
                off += int((diff > limit["most"]).sum())
                total += diff.numel()
        assert total > 50_000 and off <= 1e-3 * total, (
            f"after step {i}: {off} of {total} entries off by > {limit['most']}")
    assert state.step == len(xs)


def test_pose_adam_steps_match_mpa_tpu():
    """Two ``pose_modelnet40`` steps (adam-l2 1e-3, wd 1e-4, cosine to 1e-5;
    dropout 0) at B = 16 from the same weights on the same batches, each
    held to losses within 1e-5 and all but 0.1% of the entries within 1e-5,
    as ``test_torch_port_train.py::test_adam_steps_match_mpa_tpu`` holds
    cls's."""
    xs = [_x(20 + i, (16, N, 3)) for i in range(2)]
    ys = [rotation_6d_to_matrix(torch.from_numpy(_x(30 + i, (16, 6)))).numpy() for i in range(2)]
    limits = [dict(loss=1e-5, most=1e-5)] * 2
    _adam_steps("pose", JaxMarkovPose(dropout=0.0, **ENCODER), MarkovPose(dropout=0.0, **ENCODER),
                xs, ys, jax_geodesic, limits)


def test_completion_adam_steps_match_mpa_tpu():
    """Two ``completion`` steps from the same weights on the same (partial,
    full) batches, B = 16. Step 1 as pose's (read: 140 of 1.35M entries
    beyond 1e-5). Step 2 starts from weights that differ by step 1's
    rounding, which Adam turns into differences of ``lr`` where a gradient
    is near zero; that moves some of the Chamfer distance's nearest
    neighbours, and with them whole gradients: all but 0.1% of the entries
    within 1e-3 (read: about 140 beyond 1e-3, 6000 beyond 1e-4), the loss
    within 1e-5."""
    full = [_x(40 + i, (16, 2 * N, 3)) for i in range(2)]
    xs = [cli_train.completion_arrays(f)[0] for f in full]
    kw = dict(num_coarse=32, **ENCODER)
    limits = [dict(loss=1e-5, most=1e-5), dict(loss=1e-5, most=1e-3)]
    _adam_steps("completion", JaxMarkovCompletion(**kw), MarkovCompletion(**kw), xs, full,
                jtr.completion_loss, limits)


def test_registry_and_presets_match_mpa_tpu():
    for name, cls in (("markov_pose", MarkovPose), ("markov_completion", MarkovCompletion)):
        assert isinstance(get_model(name, **ENCODER), cls)
    for preset in ("pose_modelnet40", "completion"):
        cfg, want = PRESETS[preset], JAX_PRESETS[preset]
        for field in ("task", "model", "num_points", "batch_size", "optimizer", "learning_rate",
                      "weight_decay", "scheduler", "eta_min", "epochs", "seed", "num_classes",
                      "aug_scale", "aug_shift"):
            assert getattr(cfg, field) == getattr(want, field), (preset, field)
        assert model_kwargs(cfg) == {}  # the model defaults, as mpa_tpu's get_model(cfg.model)
    with pytest.raises(ValueError, match="dropout"):
        MarkovPose(dropout=1.0)


# -- the losses ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-6)])
def test_chamfer_and_completion_loss_match_mpa_tpu(dtype, atol):
    """The distances follow the input dtype (float64 stays float64, as
    ``mpa_tpu`` promotes them), with the gradients into both clouds; two
    points of ``pred`` on ``target`` points (distance exactly 0, the clamp)."""
    pred, target = _x(6, (3, 40, 3), dtype), _x(7, (3, 50, 3), dtype)
    coarse = _x(8, (3, 10, 3), dtype)
    pred[:, :2] = target[:, 5:7]
    with jax.enable_x64(dtype == np.float64):
        want, (wp, wt) = jax.value_and_grad(jtr.chamfer_distance, argnums=(0, 1))(
            jnp.asarray(pred), jnp.asarray(target))
        want_cl = jtr.completion_loss((jnp.asarray(coarse), jnp.asarray(pred)),
                                      jnp.asarray(target))
    p, t = (torch.from_numpy(a).requires_grad_(True) for a in (pred, target))
    got = chamfer_distance(p, t)
    got.backward()
    assert got.dtype == p.dtype
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=atol)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(wp), rtol=0, atol=atol)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(wt), rtol=0, atol=atol)
    got_cl = completion_loss((torch.from_numpy(coarse), torch.from_numpy(pred)),
                             torch.from_numpy(target))
    np.testing.assert_allclose(float(got_cl), float(want_cl), rtol=0, atol=2 * atol)


# -- data ---------------------------------------------------------------------------------


def test_realistic_clouds_and_task_arrays_bit_equal():
    for canonical in (True, False):
        got = realistic_clouds(6, 256, 15, seed=3, canonical_pose=canonical)
        want = jax_realistic_clouds(6, 256, 15, seed=3, canonical_pose=canonical)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(surface_clouds(6, 256, seed=3)[0],
                                  realistic_clouds(6, 256, seed=3)[0])
    pts = realistic_clouds(6, 256, seed=3, canonical_pose=True)[0]
    for g, w in zip(cli_train.pose_arrays(pts, 5), jax_cli_train._pose_arrays(pts, 5)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    wide = np.concatenate([pts, _x(9, pts.shape)], -1)  # normals: the crop keeps every channel
    for g, w in zip(cli_train.completion_arrays(wide), jax_cli_train._completion_arrays(wide)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _modelnet_tree(root: Path, n_train=4, n_test=3, rows=1024) -> str:
    """A ModelNet40 text tree of ``rows`` xyz + normal rows a shape."""
    root.mkdir(exist_ok=True)
    r = np.random.default_rng(1)
    names = ["airplane", "bed"]
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    ids = []
    for i in range(n_train + n_test):
        name = names[i % 2]
        (root / name).mkdir(exist_ok=True)
        ids.append(f"{name}_{i:04d}")
        np.savetxt(root / name / f"{ids[-1]}.txt", r.normal(size=(rows, 6)).astype(np.float32),
                   fmt="%.6f", delimiter=",")
    (root / "modelnet40_train.txt").write_text("\n".join(ids[:n_train]) + "\n")
    (root / "modelnet40_test.txt").write_text("\n".join(ids[n_train:]) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def modelnet_root(tmp_path_factory):
    return _modelnet_tree(tmp_path_factory.mktemp("modelnet_pose"))


@pytest.mark.parametrize("task", ["pose", "completion"])
@pytest.mark.parametrize("dataset", ["synthetic", "modelnet40"])
def test_load_dataset_bit_equal_to_mpa_tpu(task, dataset, modelnet_root, tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))  # the ModelNet cache, if any, lands here
    preset = "pose_modelnet40" if task == "pose" else "completion"
    kw = dict(dataset=dataset, data_root=modelnet_root if dataset == "modelnet40" else None)
    if dataset == "synthetic":
        kw["num_points"] = 512 if task == "pose" else 1024
    got = cli_train.load_dataset(PRESETS[preset].with_overrides(**kw))
    want = jax_cli_train.load_dataset(JAX_PRESETS[preset].with_overrides(**kw))
    for g_split, w_split in zip(got, want):
        for g, w in zip(g_split, w_split):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    n = (512, 128) if dataset == "synthetic" else (4, 3)
    assert (len(got[0][0]), len(got[1][0])) == n


# -- the eval metrics, the serving loaders and the CLI -------------------------------------------


@pytest.mark.parametrize("task", ["pose", "completion"])
def test_eval_metric_is_the_mean_of_batch_means(task):
    """Ten eval clouds in batches of 4 (4, 4 and a ragged 2): the port's
    metric is the unweighted mean of the three batch means of ``mpa_tpu``'s
    metric on the same outputs (the geodesic error in degrees; the fine
    cloud's Chamfer distance), not the mean over clouds."""
    preset = "pose_modelnet40" if task == "pose" else "completion"
    cfg = PRESETS[preset].with_overrides(batch_size=4)
    kw = dict(**ENCODER, **({"num_coarse": 16} if task == "completion" else {}))
    model = init_like_flax(get_model(cfg.model, **kw), torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, CPU)
    pts = realistic_clouds(10, 2 * N, seed=4, canonical_pose=True)[0]
    arrays = cli_train.pose_arrays(pts, 2) if task == "pose" else cli_train.completion_arrays(pts)
    got = cli_train.evaluate(cfg, state, arrays, CPU)
    means = []
    for lo in (0, 4, 8):
        with torch.inference_mode():
            out = model.eval()(torch.from_numpy(arrays[0][lo:lo + 4]))
        if task == "pose":
            means.append(float(jax_geodesic(jnp.asarray(out.numpy()),
                                            jnp.asarray(arrays[1][lo:lo + 4]))))
        else:
            means.append(float(jtr.chamfer_distance(jnp.asarray(out[1].numpy()),
                                                    jnp.asarray(arrays[1][lo:lo + 4]))))
    want = float(np.mean(means)) * (180.0 / np.pi if task == "pose" else 1.0)
    key, sign = cli_train.CHECKPOINT_METRIC[task]
    assert sign == -1 and key in got
    np.testing.assert_allclose(got[key], want, rtol=1e-5)


def test_pose_resample_rotates_points_and_targets_alike():
    """The per-batch z-rotation: the same rotation on the cloud and on its
    target (so ``target^T`` undoes both), drawn from the run's seed and
    the step alone."""
    cfg = PRESETS["pose_modelnet40"]
    pts, rot = (torch.from_numpy(a) for a in cli_train.pose_arrays(
        realistic_clouds(4, 64, seed=0, canonical_pose=True)[0], 0))
    p1, r1 = cli_train.pose_resample(cfg, pts, rot, step=7)
    p2, r2 = cli_train.pose_resample(cfg, pts, rot, step=7)
    p3, _ = cli_train.pose_resample(cfg, pts, rot, step=8)
    assert torch.equal(p1, p2) and torch.equal(r1, r2) and not torch.equal(p1, p3)
    # r1 = R2 rot and p1 = R2 pts, so rot^T r1^T... back to the canonical cloud
    back = torch.einsum("bji,bnj->bni", r1, p1)
    canon = torch.einsum("bji,bnj->bni", rot, pts)
    torch.testing.assert_close(back, canon, rtol=0, atol=1e-5)
    torch.testing.assert_close(r1 @ r1.transpose(1, 2), torch.eye(3).expand(4, 3, 3),
                               rtol=0, atol=1e-6)


def test_serving_loaders_on_cpu():
    x = realistic_clouds(2, 1024, seed=5, canonical_pose=True)[0]
    kernels.reset_launch_counts()
    pose = load_pose_regressor(device="cpu", seed=1)
    r = pose(x)
    assert tuple(r.shape) == (2, 3, 3) and torch.isfinite(r).all()
    torch.testing.assert_close(r @ r.transpose(1, 2), torch.eye(3).expand(2, 3, 3), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(r, load_pose_regressor(device="cpu", seed=1)(torch.from_numpy(x)),
                               rtol=0, atol=0)
    partial, _ = cli_train.completion_arrays(x)
    coarse, fine = load_completer(device="cpu", seed=1)(partial)
    assert tuple(coarse.shape) == (2, 256, 3) and tuple(fine.shape) == (2, 512 + 1024, 3)
    assert torch.isfinite(fine).all()
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
    with pytest.raises(ValueError, match="pose"):
        load_pose_regressor("completion", device="cpu")
    with pytest.raises(ValueError, match="completion"):
        load_completer("pose_modelnet40", device="cpu")


@pytest.mark.parametrize("preset", ["pose_modelnet40", "completion"])
@pytest.mark.parametrize("dataset", ["synthetic", "modelnet40"])
def test_cli_train_two_steps_on_cpu(preset, dataset, modelnet_root, tmp_path, monkeypatch,
                                    capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    data = ["--dataset", dataset] + (["--data_root", modelnet_root]
                                     if dataset == "modelnet40" else
                                     ["--train_clouds", "4", "--eval_clouds", "3"])
    kernels.reset_launch_counts()
    out = cli_train.main(["--preset", preset, "--device", "cpu", "--max_steps", "2",
                          "--batch_size", "2", "--seed", "0", "--log_dir", str(tmp_path), *data])
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert out["aug_delta"] is None  # no augmentation unless asked
    key = "geodesic_error_deg" if preset == "pose_modelnet40" else "chamfer"
    assert np.isfinite(out[key]) and out[key] >= 0.0
    log = capsys.readouterr().out
    assert ("mean geodesic error" if key == "geodesic_error_deg"
            else "eval after 2 steps: chamfer") in log
    assert (tmp_path / f"{preset}_{dataset}" / "checkpoints").is_dir()
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
    # --dry_data_check on the same data, and a dataset the task has no data for
    args = ["--preset", preset, "--dry_data_check", *data]
    assert cli_train.main(args) == 0
    assert '"ok": true' in capsys.readouterr().out
    assert cli_train.main(["--preset", preset, "--dry_data_check", "--dataset",
                           "shapenetpart"]) == 1
