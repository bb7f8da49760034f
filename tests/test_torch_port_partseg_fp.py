"""Port parity, ``markov_partseg_fp`` (the feature-propagation part-seg
model) on the CPU: ``three_nn_interpolate`` and its gradient,
``PointNetFeaturePropagation`` (the broadcast of one coarse point, the skip
concatenation), the whole model's eval forward on the preset's 4-level
ladder and on the model's 5-level default, its module tree at full width
against flax's, its eval-mode gradients and two SGD steps of the
``shapenetpart_fp`` recipe against ``mpa_tpu``'s train step, the refusal of
the window modes and of a keyed FPS start, ``load_segmenter("shapenetpart_fp")``
and a two-step ``cli.train --preset shapenetpart_fp``.

``mpa_tpu`` runs as its own tests run it (JAX on the CPU, jitted; its kNN
and attention take their XLA forms there); the port takes its plain ops,
because the tensors lie on the CPU. The kernels these paths launch on the
card (``knn_kernel`` with k = 3, ``fps_kernel`` on feature clouds, the
gathers) are held against the plain ops in
``tests/test_torch_port_cuda_paths.py`` and by ``chip_smoke.py``.

Tolerances: the interpolation within 1e-5 absolute on features of size 1
(its weights come from squared distances that both sides take in the
expanded form ``|q|^2 + |b|^2 - 2 q.b``, rounded in float32 in another
order: where a distance is small the cancellation leaves it a few percent
of relative error, which moved the interpolated values by up to 2.2e-6);
log-probs
within 1e-4 (the cls and part-seg bound); eval-mode gradients within 1e-4
absolute and 1e-3 relative (``test_grad_parity.py``'s bounds); the SGD
steps as ``test_torch_port_partseg_train.py`` holds part-seg's, each bound
given at the test with its reading.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import _nest, port, state_to_flax  # noqa: E402
from test_torch_port_pose_completion import jax_variables  # noqa: E402
from test_torch_port_train import _jax_state_to_port, _params_of  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.configs.presets import PRESETS as JAX_PRESETS  # noqa: E402
from mpa_tpu.models import MarkovPartSegFP as JaxMarkovPartSegFP  # noqa: E402
from mpa_tpu.nn.feature_propagation import (  # noqa: E402
    PointNetFeaturePropagation as JaxFeaturePropagation,
)
from mpa_tpu.ops import three_nn_interpolate as jax_three_nn_interpolate  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS, model_kwargs  # noqa: E402
from mpa_tpu_torch.models import MarkovPartSegFP, get_model  # noqa: E402
from mpa_tpu_torch.nn import PointNetFeaturePropagation  # noqa: E402
from mpa_tpu_torch.ops import three_nn_interpolate  # noqa: E402
from mpa_tpu_torch.serve import load_segmenter  # noqa: E402
from mpa_tpu_torch.train import create_train_state, make_partseg_train_step  # noqa: E402
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402

CPU = torch.device("cpu")
N = 128  # cloud size of the model tests
# The preset's ladder, as cli.train scales it to N, and the model's default
# 5-level ladder at the same size; narrow widths.
PRESET_KW = dict(model_kwargs(PRESETS["shapenetpart_fp"].with_overrides(num_points=N)),
                 channels=(16, 16, 16, 32, 32, 64))
PRESET_KW.pop("neighbor_mode"), PRESET_KW.pop("fps_min_band"), PRESET_KW.pop("fps_min_samples")
DEFAULT_KW = dict(npoints=(128, 64, 32, 16, 8), channels=(16, 16, 16, 32, 32, 64))  # at 256


def _inputs(seed, B=2, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, n, 3)).astype(np.float32)
    onehot = np.eye(16, dtype=np.float32)[rng.integers(0, 16, B)]
    return x, onehot


def _point_nll(log_probs, seg):
    return -torch.gather(log_probs, 2, seg[..., None]).mean()


# -- the interpolation and the propagation unit ---------------------------------------


# (B, N fine, S coarse, C, duplicated fine points on coarse ones)
INTERP_CASES = [(2, 64, 16, 8, False), (1, 128, 3, 5, False), (3, 40, 20, 16, True)]


@pytest.mark.parametrize("B,n,S,C,dup", INTERP_CASES)
def test_three_nn_interpolate_matches_mpa_tpu(B, n, S, C, dup):
    """Values and the gradient into the features within 1e-5; with ``dup``
    every coarse point is also a fine one (distance 0, weight 1e8: the fine
    point takes that row)."""
    rng = np.random.default_rng(B * 100 + S)
    fine = rng.standard_normal((B, n, 3)).astype(np.float32)
    coarse = rng.standard_normal((B, S, 3)).astype(np.float32)
    if dup:
        fine[:, :S] = coarse
    feats = rng.standard_normal((B, S, C)).astype(np.float32)
    g = rng.standard_normal((B, n, C)).astype(np.float32)
    def fn(f):
        return jnp.sum(jax_three_nn_interpolate(jnp.asarray(fine), jnp.asarray(coarse), f)
                       * jnp.asarray(g))

    want = np.asarray(jax_three_nn_interpolate(jnp.asarray(fine), jnp.asarray(coarse),
                                               jnp.asarray(feats)))
    want_grad = np.asarray(jax.grad(fn)(jnp.asarray(feats)))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = three_nn_interpolate(torch.from_numpy(fine), torch.from_numpy(coarse), f)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), want_grad, rtol=0, atol=1e-5)
    if dup:
        np.testing.assert_allclose(got.detach().numpy()[:, :S], feats, rtol=0, atol=1e-5)


@pytest.mark.parametrize("S,skip", [(16, False), (16, True), (1, False), (1, True)])
def test_feature_propagation_matches_mpa_tpu(S, skip):
    """Eval mode, BatchNorm statistics randomised: within 1e-5. ``S = 1``
    broadcasts the one coarse row to every fine point."""
    rng = np.random.default_rng(S + 10 * skip)
    B, n, C, Cs, out = 2, 48, 12, 5, 8
    fine = jnp.asarray(rng.standard_normal((B, n, 3)).astype(np.float32))
    coarse = jnp.asarray(rng.standard_normal((B, S, 3)).astype(np.float32))
    feats = jnp.asarray(rng.standard_normal((B, S, C)).astype(np.float32))
    sk = jnp.asarray(rng.standard_normal((B, n, Cs)).astype(np.float32)) if skip else None
    jm = JaxFeaturePropagation(out, act=True)
    flat = jax_variables(jm, fine, coarse, feats, sk)
    want = np.asarray(jm.apply(_nest(flat), fine, coarse, feats, sk, train=False))
    tm, unused = port(PointNetFeaturePropagation(C + (Cs if skip else 0), out), flat)
    assert unused == []
    t = [None if a is None else torch.from_numpy(np.array(a)) for a in (fine, coarse, feats, sk)]
    with torch.inference_mode():
        got = tm(*t).numpy()
    assert got.shape == (B, n, out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- the whole model --------------------------------------------------------------------


@pytest.fixture(scope="module")
def preset_model():
    """``mpa_tpu``'s model on the preset ladder, its variables, and its
    jitted eval output and eval-mode gradients of the mean per-point NLL on
    one batch (one compile for the forward and the gradients)."""
    x, onehot = _inputs(7)
    seg = np.random.default_rng(8).integers(0, 50, (2, N))
    jm = JaxMarkovPartSegFP(dropout=0.0, **PRESET_KW)
    flat = jax_variables(jm, (jnp.asarray(x), jnp.asarray(onehot)))

    def loss(params, xx):
        out = jm.apply({"params": params, "batch_stats": _nest(flat)["batch_stats"]},
                       (xx, jnp.asarray(onehot)), train=False)
        nll = -jnp.mean(jnp.take_along_axis(out, jnp.asarray(seg)[..., None], axis=-1))
        return nll, out

    (val, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        _nest(flat)["params"], jnp.asarray(x))
    return dict(x=x, onehot=onehot, seg=seg, flat=flat, loss=float(val), out=np.asarray(out),
                grads=grads)


def test_markov_partseg_fp_preset_ladder_matches_mpa_tpu(preset_model):
    m = preset_model
    assert PRESET_KW["npoints"] == (64, 32, 16, 8)  # N / 2 .. N / 16: four levels
    tm, unused = port(MarkovPartSegFP(dropout=0.0, **PRESET_KW), m["flat"])
    assert unused == []
    assert not hasattr(tm, "la5") and not hasattr(tm, "upla5")  # channels[5] unused
    with torch.inference_mode():
        got = tm((torch.from_numpy(m["x"]), torch.from_numpy(m["onehot"]))).numpy()
    assert got.shape == (2, N, 50) and np.isfinite(got).all()
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, m["out"], rtol=0, atol=1e-4)


def test_markov_partseg_fp_default_ladder_matches_mpa_tpu():
    """The model's own 5-level default (``la5``, ``upla5``, ``up6_5`` and
    ``channels[5]`` built), which cli.train does not use."""
    x, onehot = _inputs(9, n=256)
    jm = JaxMarkovPartSegFP(**DEFAULT_KW)
    flat = jax_variables(jm, (jnp.asarray(x), jnp.asarray(onehot)))
    want = np.asarray(jax.jit(lambda v, p, o: jm.apply(v, (p, o), train=False))(
        _nest(flat), jnp.asarray(x), jnp.asarray(onehot)))
    tm, unused = port(MarkovPartSegFP(**DEFAULT_KW), flat)
    assert unused == [] and hasattr(tm, "up6_5")
    with torch.inference_mode():
        got = tm((torch.from_numpy(x), torch.from_numpy(onehot))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("ladder", ["preset", "default"])
def test_full_width_module_tree_matches_flax(ladder):
    """At the published widths and 2048 points, the port builds exactly the
    modules flax's init makes (shapes from ``jax.eval_shape``, no compute):
    every leaf has a home and every port entry one leaf, strictly."""
    kw = (model_kwargs(PRESETS["shapenetpart_fp"]) if ladder == "preset"
          else dict(npoints=(1024, 512, 256, 128, 64)))
    tm = get_model("markov_partseg_fp", **kw)
    kw.pop("neighbor_mode", None), kw.pop("fps_min_band", None), kw.pop("fps_min_samples", None)
    shapes = jax.eval_shape(
        lambda: JaxMarkovPartSegFP(**kw).init(
            jax.random.key(0), (jnp.zeros((2, 2048, 3)), jnp.zeros((2, 16))), train=False))
    flat = {"/".join(str(p.key) for p in path): np.zeros(leaf.shape, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    state, unused = from_jax_variables(flat, tm)
    assert unused == []
    tm.load_state_dict(state, strict=True)
    levels = len(kw["npoints"])
    assert hasattr(tm, f"la{levels}") and not hasattr(tm, f"la{levels + 1}")


def test_markov_partseg_fp_eval_grads_match_mpa_tpu(preset_model):
    """Eval-mode gradients of the mean per-point NLL with respect to every
    parameter and the input cloud."""
    m = preset_model
    tm, _ = port(MarkovPartSegFP(dropout=0.0, **PRESET_KW), m["flat"])
    x = torch.from_numpy(m["x"]).requires_grad_(True)
    loss = _point_nll(tm((x, torch.from_numpy(m["onehot"]))), torch.from_numpy(m["seg"]))
    loss.backward()
    assert abs(float(loss.detach()) - m["loss"]) < 5e-5
    gparams, gx = m["grads"]
    flat = {"params/" + "/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(gparams)[0]}
    want, unused = from_jax_variables(flat, tm)
    assert unused == []
    params = _params_of(tm)
    assert set(want) == set(params) and len(params) > 100
    for name, p in params.items():
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=f"grad mismatch at {name}")
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=1e-4, rtol=1e-3)


def test_sgd_steps_match_mpa_tpu():
    """Two steps of the ``shapenetpart_fp`` recipe (SGD 0.1, momentum 0.9,
    wd 1e-4, cosine to 1e-3, smoothing 0.1; dropout 0) from the same
    weights on the same batches: after each step the loss, every parameter
    and the running statistics.

    Tolerances. Step 1 starts from identical weights: loss within 1e-5,
    every entry within 1e-4, all but 0.1% within 1e-5. Step 2 starts from
    weights that differ by the first step's rounding, which train-mode
    BatchNorm and the near-tie selections (the feature-space FPS, the max
    over K and the max pool) amplify: loss within 1e-3, every entry within
    2e-2, all but 0.1% within 1e-3 (part-seg's bounds,
    ``test_torch_port_partseg_train.py``)."""
    cfg = PRESETS["shapenetpart_fp"]
    assert (cfg.optimizer, cfg.learning_rate, cfg.momentum, cfg.weight_decay, cfg.scheduler,
            cfg.eta_min) == ("sgd", 0.1, 0.9, 1e-4, "cos", 1e-3)
    B, spe = 8, 4
    limits = [dict(loss=1e-5, entry=1e-4, most=1e-5, share=1e-3),
              dict(loss=1e-3, entry=2e-2, most=1e-3, share=1e-3)]
    batches = [_inputs(20 + i, B) for i in range(len(limits))]
    segs = [np.random.default_rng(30 + i).integers(0, 50, (B, N)) for i in range(len(limits))]
    jm = JaxMarkovPartSegFP(dropout=0.0, **PRESET_KW)
    flat = jax_variables(jm, tuple(jnp.asarray(a) for a in batches[0]))
    nested = _nest(flat)
    sched = jtr.cosine_schedule(cfg.learning_rate, cfg.epochs, cfg.eta_min)
    tx = jtr.make_optimizer("sgd", lambda step: sched(step // spe), cfg.weight_decay, cfg.momentum)
    jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"], tx=tx,
                                   batch_stats=nested["batch_stats"])
    jstep = jax.jit(jtr.make_train_step(lambda out, y: jtr.smooth_seg_loss(out, y, 0.1)))
    model, _ = port(MarkovPartSegFP(dropout=0.0, **PRESET_KW), flat)
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
        assert total > 30_000 and off <= limit["share"] * total, (
            f"after step {i}: {off} of {total} entries off by > {limit['most']}")
    assert state.step == len(limits)


def test_preset_and_refusals():
    want, cfg = JAX_PRESETS["shapenetpart_fp"], PRESETS["shapenetpart_fp"]
    for field in ("task", "model", "num_points", "batch_size", "optimizer", "learning_rate",
                  "weight_decay", "momentum", "scheduler", "eta_min", "epochs", "seed",
                  "aug_scale", "aug_shift", "label_smoothing"):
        assert getattr(cfg, field) == getattr(want, field), field
    assert model_kwargs(cfg)["npoints"] == (1024, 512, 256, 128)
    for mode in ("window", "window_all"):
        with pytest.raises(ValueError, match="exact"):
            get_model("markov_partseg_fp", neighbor_mode=mode)
        with pytest.raises(ValueError, match="exact"):
            load_segmenter("shapenetpart_fp", device="cpu", neighbor_mode=mode)
    with pytest.raises(ValueError, match="dropout"):
        MarkovPartSegFP(dropout=1.0)


# -- the entry points -------------------------------------------------------------------


def test_load_segmenter_shapenetpart_fp_on_cpu():
    """From a seed: the same weights twice, finite log-probs whose rows sum
    to 1, the category reaching the output, plain ops only; its weights
    carried out as flax variables and back, strictly and unchanged."""
    x, _ = _inputs(11)
    kernels.reset_launch_counts()
    seg = load_segmenter("shapenetpart_fp", device="cpu", seed=2, num_points=N)
    assert isinstance(seg.model, MarkovPartSegFP) and seg.model.npoints == (64, 32, 16, 8)
    a = seg(x, [3, 4])
    b = load_segmenter("shapenetpart_fp", device="cpu", seed=2, num_points=N)(x, [3, 4])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tuple(a.shape) == (2, N, 50) and torch.isfinite(a).all()
    torch.testing.assert_close(a.exp().sum(-1), torch.ones(2, N))
    assert not torch.equal(a, seg(x, [3, 5]))
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
    again = load_segmenter("shapenetpart_fp", state_to_flax(seg.model.state_dict()),
                           device="cpu", num_points=N)
    ref = seg.model.state_dict()
    assert all(torch.equal(ref[k], v) for k, v in again.model.state_dict().items())


def test_cli_train_shapenetpart_fp_two_steps_on_cpu(tmp_path, capsys):
    kernels.reset_launch_counts()
    out = cli_train.main(["--preset", "shapenetpart_fp", "--device", "cpu", "--max_steps", "2",
                          "--num_points", "256", "--batch_size", "2", "--train_clouds", "4",
                          "--eval_clouds", "3", "--seed", "0", "--log_dir", str(tmp_path)])
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert out["aug_delta"] > 0  # part-seg's scale and shift augmentation
    assert 0.0 <= out["ins_miou"] <= 1.0 and 0.0 <= out["class_miou"] <= 1.0
    log = capsys.readouterr().out
    assert "model markov_partseg_fp" in log and "ins-mIoU" in log
    assert (tmp_path / "shapenetpart_fp_synthetic" / "checkpoints").is_dir()
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
    with pytest.raises(ValueError, match="exact"):
        cli_train.main(["--preset", "shapenetpart_fp", "--device", "cpu", "--max_steps", "1",
                        "--neighbor_mode", "window", "--num_points", "256",
                        "--log_dir", str(tmp_path / "w")])


# -- the kernels' forms at every launch shape of the new paths ----------------------------


def _new_path_launches():
    """Every FPS, gather and scatter-add launch of one request and one train
    step of ``markov_partseg_fp`` (B = 32 x 2048, channels 64/64/64/128/256),
    ``markov_pose`` (B = 64 x 1024) and ``markov_completion`` (B = 64 x 512
    partial points): ``(fps [(B, N, C, npoint)], gathers [(B, N, W, rows
    a cloud)], scatter-adds [(B, E, W, N)])``."""
    fps, gathers, adds = [], [], []
    B, n, ch = 32, 2048, (64, 64, 64, 128, 256)
    sizes = [n // 2 ** i for i in range(5)]
    for i in range(4):  # encoder levels: FPS on features, new_xyz and center_feat
        fps.append((B, sizes[i], ch[i], sizes[i + 1]))
        gathers += [(B, sizes[i], 3, sizes[i + 1]), (B, sizes[i], ch[i], sizes[i + 1])]
        adds.append((B, sizes[i + 1], ch[i], sizes[i]))
    for s in range(4):  # the interpolations: 3 rows a fine point
        gathers.append((B, sizes[s + 1], ch[s + 1], 3 * sizes[s]))
        adds.append((B, 3 * sizes[s], ch[s + 1], sizes[s + 1]))
    cls_ch = (64, 64, 64, 128, 256)
    for B, n in ((64, 1024), (64, 512)):  # pose, completion: the cls encoder
        sizes = [n] + [512 // 2 ** i for i in range(5)]
        for i in range(5):
            fps.append((B, sizes[i], 3, sizes[i + 1]))
            gathers += [(B, sizes[i], 3, sizes[i + 1]), (B, sizes[i], cls_ch[i], sizes[i + 1])]
            adds.append((B, sizes[i + 1], cls_ch[i], sizes[i]))
    return fps, gathers, adds


def test_kernel_forms_take_every_new_path_shape():
    """``fps_form``, ``gather_form`` and ``scatter_add_form`` give a form the
    kernels take (their entries refuse any other) at every launch shape of
    the three new paths, and the sizes stay inside the kernels' limits; the
    card runs them in ``tests/test_torch_port_cuda_paths.py`` and
    ``chip_smoke.py``."""
    from mpa_tpu_torch.ops.fps import fps_form
    from mpa_tpu_torch.ops.gather import MAX_B, gather_form, scatter_add_form

    fps, gathers, adds = _new_path_launches()
    assert (64, 512, 3, 512) in fps  # completion's first level takes every point
    for B, n, C, npoint in fps:
        resident, cs, nw = fps_form(B, n, C)
        assert 1 <= npoint <= n and cs in (1, 2, 4, 8, 16) and 1 <= nw <= 16
        assert resident == (C == 3)
    for B, n, W, rows in gathers:
        points = torch.empty((B, n, W))
        vec, elems = gather_form(points, B * rows)
        assert vec in (1, 2, 4) and W % vec == 0 and elems in (1, 2)
        assert B * n < 2**31 and B * rows * W < 2**31
    for B, E, W, n in adds:
        slots, vec = scatter_add_form(torch.empty((B, E, W)), n)
        assert B <= MAX_B and 8 <= slots <= 256 and vec in (1, 2, 4) and W % vec == 0
