"""Port parity, the model options that raised before, on the CPU.

- Keyed FPS starts: the cls encoder (``fps_random_start``), ``markov_partseg``,
  ``markov_partseg_fp`` and ``markov_semseg`` in ``window_all`` (banded
  starts), in train mode, against ``mpa_tpu`` given ``rng``. Torch cannot
  replay JAX's PRNG, so the port gets the very starts ``mpa_tpu`` draws
  (``jax.random.randint`` over the ``jax.random.split`` of the key, one
  folded ``[B * n_bands]`` draw a banded scale) through ``fps_starts``. The
  log-probs agree within 1e-5 relative and the train-mode gradients of an NLL
  within ``chip_smoke.grad_error_units``' ``grad_limit`` (20 units of 1e-3
  of each gradient's norm), which the card-against-CPU steps use. The
  port's own draws (``fps_generator``) are seeded, in range and ignored in
  eval mode.
- ``use_tanh``: ``LocalTrans`` (both modes) and ``LocalMerge`` (the cls and
  the three-branch part-seg forms), forward and gradients.
- ``LinearUnit(norm="layer")`` against ``mpa_tpu`` and the frozen
  reference fixture ``nn_linear_unit_layer.npz``.
- ``mi_aux_loss``: value and gradient.
- The constructor options ``mpa_tpu`` has beyond its defaults, each at a
  non-default value against its ``mpa_tpu`` module:
  ``UmbrellaSurfaceConstructor(k, channels, aggr_type, return_dist,
  random_inv)`` in eval and train mode (its running statistics too),
  ``SurfaceAbstractionCD(pos_channel, return_polar, return_normal)``,
  ``MarkovClassifier(umbrella_k, umbrella_aggr)`` in train mode (where the
  umbrella runs) with the flips ``mpa_tpu`` draws from its key,
  ``RepSurfSSG2x(umbrella_k, umbrella_aggr, return_dist, return_polar)``
  and ``PointNetFeaturePropagation(dtype=torch.bfloat16)``. Tolerances: the
  modules within 1e-5 (1e-4 in train mode for the set abstraction and for
  the whole repsurf classifier, as ``test_torch_port_repsurf.py`` holds
  them), the classifier's train-mode log-probs within 1e-4; bf16 within
  one bf16 rounding of the output's largest entry (``2^-8`` of it: the
  float32 sums of a bf16 product in another order may round to the
  neighbouring bf16 value), the output bf16 on both sides.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle_cache import oracle, subtree  # noqa: E402
from test_torch_port_cls import SMALL, _nest, _x, jax_variables, port  # noqa: E402
from test_torch_port_repsurf import SMALL as REPSURF_SMALL  # noqa: E402
from test_torch_port_repsurf import _sa_inputs  # noqa: E402

import chip_smoke  # noqa: E402  (grad_error_units and its limit; imports torch only)
from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu.models import MarkovPartSegFP as JaxMarkovPartSegFP  # noqa: E402
from mpa_tpu.models import MarkovSemSeg as JaxMarkovSemSeg  # noqa: E402
from mpa_tpu.nn import KeepHighResolutionEncoder as JaxEncoder  # noqa: E402
from mpa_tpu.nn import LinearUnit as JaxLinearUnit  # noqa: E402
from mpa_tpu.nn import LocalMerge as JaxLocalMerge  # noqa: E402
from mpa_tpu.nn import LocalTrans as JaxLocalTrans  # noqa: E402
from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.models.repsurf_ssg_2x import RepSurfSSG2x as JaxRepSurf  # noqa: E402
from mpa_tpu.nn.feature_propagation import (  # noqa: E402
    PointNetFeaturePropagation as JaxFeaturePropagation,
)
from mpa_tpu.nn.surface_abstraction import SurfaceAbstractionCD as JaxSACD  # noqa: E402
from mpa_tpu.nn.umbrella_constructor import UmbrellaSurfaceConstructor as JaxUmbrella  # noqa: E402
from mpa_tpu.train.losses import mi_aux_loss as jax_mi_aux_loss  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier, MarkovPartSeg, MarkovPartSegFP  # noqa: E402
from mpa_tpu_torch.models import MarkovSemSeg, RepSurfSSG2x  # noqa: E402
from mpa_tpu_torch.nn import LinearUnit, LocalMerge, LocalTrans  # noqa: E402
from mpa_tpu_torch.nn import PointNetFeaturePropagation, SurfaceAbstractionCD  # noqa: E402
from mpa_tpu_torch.nn import UmbrellaSurfaceConstructor  # noqa: E402
from mpa_tpu_torch.nn.keephigh import KeepHighResolutionEncoder  # noqa: E402
from mpa_tpu_torch.ops.fps import pick_fps_bands  # noqa: E402
from mpa_tpu_torch.train import mi_aux_loss  # noqa: E402

ENC = dict(npoints=SMALL["npoints"], channels=SMALL["channels"], out_features=64)
PARTSEG = dict(npoints=(128, 64, 32, 16), channels=(16, 16, 16, 32, 32))
PARTSEG_FP = dict(npoints=(128, 64, 32, 16), channels=(16, 16, 16, 32, 32))
SEMSEG = dict(num_classes=5, npoints=(128, 64, 32, 16), channels=(8, 8, 8, 16, 16),
              neighbor_mode="window_all", fps_min_band=32, fps_min_samples=8)
KEY = jax.random.key(11)


def jax_starts(key, B, sizes, bands=None):
    """The starts ``mpa_tpu`` draws for the FPS scales of clouds ``sizes``
    (``bands[i]`` bands at scale i): ``[B]`` or ``[B, n_bands]`` tensors."""
    keys = jax.random.split(key, len(sizes))
    out = []
    for i, n in enumerate(sizes):
        g = bands[i] if bands else 1
        s = np.array(jax.random.randint(keys[i], (B * g,), 0, n // g, dtype=jnp.int32))
        out.append(torch.from_numpy(s.reshape(B, g) if g > 1 else s))
    return out


def _jax_train(jm, flat, inputs, labels, **kw):
    """``mpa_tpu``'s train-mode output and the gradients of the mean NLL of
    ``labels`` (per cloud, or per point for a per-point output)."""

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": _nest(flat)["batch_stats"]},
                          inputs, train=True, rng=KEY, mutable=["batch_stats"], **kw)
        nll = -jnp.mean(jnp.take_along_axis(out, jnp.asarray(labels)[..., None], axis=-1))
        return nll, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(_nest(flat)["params"])
    flat_grads = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        flat_grads["params/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    return np.asarray(out), flat_grads


def _port_train(tm, inputs, labels, starts):
    tm.train()
    out = tm(inputs, fps_starts=starts)
    idx = torch.from_numpy(np.asarray(labels)).long()[..., None]
    (-torch.gather(out, -1, idx).mean()).backward()
    # q takes no part in the folded output: torch leaves its gradient None
    return out.detach().numpy(), {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                                  for n, p in tm.named_parameters()}


def _grads_to_port(flat_grads, tm):
    from mpa_tpu_torch.utils import from_jax_variables

    converted, _ = from_jax_variables(flat_grads, tm)
    return {n: converted[n] for n, _ in tm.named_parameters()}


def _check(got_out, want_out, got_grads, want_grads):
    np.testing.assert_allclose(got_out, want_out, rtol=1e-5, atol=1e-6)
    units = chip_smoke.grad_error_units(got_grads, want_grads)
    assert units[0][1] <= chip_smoke.PATHS["cls"]["grad_limit"], units[:3]


def test_encoder_keyed_starts_match_mpa_tpu():
    """The cls encoder with ``fps_random_start``: a head of one Dense (the
    NLL of 10 classes) on its pooled feature, on both sides."""
    import flax.linen as fnn

    B, N = 8, 128
    x = _x(1, (B, N, 3))
    labels = np.random.default_rng(2).integers(0, 10, B)

    class JaxHead(fnn.Module):
        @fnn.compact
        def __call__(self, xyz, *, train=True, rng=None):
            g = JaxEncoder(fps_random_start=True, name="keep_high", **ENC)(xyz, train=train,
                                                                           rng=rng)
            return jax.nn.log_softmax(fnn.Dense(10, name="head")(g))

    class Head(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.keep_high = KeepHighResolutionEncoder(fps_random_start=True, **ENC)
            self.head = torch.nn.Linear(64, 10)

        def forward(self, xyz, **kw):
            return torch.log_softmax(self.head(self.keep_high(xyz, **kw)), dim=-1)

    jm = JaxHead()
    flat = jax_variables(jm, jnp.asarray(x))
    want_out, want = _jax_train(jm, flat, jnp.asarray(x), labels)
    starts = jax_starts(KEY, B, (N,) + ENC["npoints"][:-1])
    assert len(set(starts[0].tolist())) > 1
    tm, _ = port(Head(), flat)
    got_out, got = _port_train(tm, torch.from_numpy(x), labels, starts)
    _check(got_out, want_out, got, _grads_to_port(want, tm))


def test_partseg_keyed_starts_match_mpa_tpu():
    B, N = 4, 256
    x, cats = _x(3, (B, N, 3)), np.random.default_rng(4).integers(0, 16, B)
    onehot = np.eye(16, dtype=np.float32)[cats]
    labels = np.random.default_rng(5).integers(0, 50, (B, N))
    jm = JaxMarkovPartSeg(dropout=0.0, **PARTSEG)
    flat = jax_variables(jm, (jnp.asarray(x), jnp.asarray(onehot)))
    want_out, want = _jax_train(jm, flat, (jnp.asarray(x), jnp.asarray(onehot)), labels)
    starts = jax_starts(KEY, B, (N,) + PARTSEG["npoints"][:-1])
    tm, _ = port(MarkovPartSeg(dropout=0.0, **PARTSEG), flat)
    got_out, got = _port_train(tm, (torch.from_numpy(x), torch.from_numpy(onehot)), labels,
                               starts)
    _check(got_out, want_out, got, _grads_to_port(want, tm))


def test_partseg_fp_keyed_starts_match_mpa_tpu():
    """FPS on the feature clouds, each scale's start drawn over its rows."""
    B, N = 4, 256
    x, cats = _x(6, (B, N, 3)), np.random.default_rng(7).integers(0, 16, B)
    onehot = np.eye(16, dtype=np.float32)[cats]
    labels = np.random.default_rng(8).integers(0, 50, (B, N))
    jm = JaxMarkovPartSegFP(dropout=0.0, **PARTSEG_FP)
    flat = jax_variables(jm, (jnp.asarray(x), jnp.asarray(onehot)))
    want_out, want = _jax_train(jm, flat, (jnp.asarray(x), jnp.asarray(onehot)), labels)
    starts = jax_starts(KEY, B, (N,) + PARTSEG_FP["npoints"][:-1])
    tm, _ = port(MarkovPartSegFP(dropout=0.0, **PARTSEG_FP), flat)
    got_out, got = _port_train(tm, (torch.from_numpy(x), torch.from_numpy(onehot)), labels,
                               starts)
    _check(got_out, want_out, got, _grads_to_port(want, tm))


def test_semseg_window_all_banded_starts_match_mpa_tpu():
    """``window_all`` with band floors low enough that the first three scales
    band: one band-local start a band (``[B, n_bands]``); the last scale's
    FPS is exact, with ``[B]`` starts."""
    B, N = 2, 256
    x = np.random.default_rng(9).standard_normal((B, N, 9)).astype(np.float32)
    labels = np.random.default_rng(10).integers(0, 5, (B, N))
    sizes = (N,) + SEMSEG["npoints"][:-1]
    bands = [pick_fps_bands(n, s, min_band=32, min_samples=8)
             for n, s in zip(sizes, SEMSEG["npoints"])]
    assert bands == [8, 4, 2, 1]
    jm = JaxMarkovSemSeg(dropout=0.0, **SEMSEG)
    flat = jax_variables(jm, jnp.asarray(x))
    want_out, want = _jax_train(jm, flat, jnp.asarray(x), labels)
    starts = jax_starts(KEY, B, sizes, bands)
    tm, _ = port(MarkovSemSeg(dropout=0.0, **SEMSEG), flat)
    got_out, got = _port_train(tm, torch.from_numpy(x), labels, starts)
    _check(got_out, want_out, got, _grads_to_port(want, tm))


def test_the_ports_own_draws():
    """``fps_generator`` draws in range, the same for the same seed; eval
    mode and the switch off ignore it; the switch on needs starts."""
    x = torch.from_numpy(_x(12, (3, 128, 3)))
    enc = KeepHighResolutionEncoder(fps_random_start=True, **ENC).train()

    def run(seed):
        with torch.no_grad():
            return enc(x, fps_generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="fps_generator"):
        enc(x)
    with torch.no_grad():
        eval_a = enc.eval()(x, fps_generator=torch.Generator().manual_seed(1))
        eval_b = enc(x)
    torch.testing.assert_close(eval_a, eval_b, rtol=0, atol=0)
    model = MarkovClassifier(num_classes=4, dropout=0.0, **SMALL).train()
    model.keep_high.fps_random_start = True
    starts = [torch.tensor([5, 0, 127])] + [torch.zeros(3, dtype=torch.int32)] * 4
    with torch.no_grad():
        a = model(x, fps_starts=starts)
        b = model(x, fps_starts=[torch.zeros(3, dtype=torch.int32)] * 5)
    assert not torch.equal(a, b)
    seg = MarkovSemSeg(**SEMSEG).train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = seg(torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 256, 9)).astype(np.float32)), generator=torch.Generator().manual_seed(5),
            fps_generator=gen)
    assert out.shape == (2, 256, 5) and torch.isfinite(out).all()


def test_train_step_takes_the_states_fps_generator():
    """``TrainState.fps_generator`` reaches the model: one cls step with
    keyed starts draws from it (its state moves), and a second state seeded
    alike takes the same step."""
    from mpa_tpu_torch.configs import PRESETS
    from mpa_tpu_torch.train import create_train_state, make_cls_train_step

    x = torch.from_numpy(_x(30, (4, 128, 3)))
    y = torch.from_numpy(np.random.default_rng(31).integers(0, 15, 4))
    cfg = PRESETS["scanobjectnn_cls"]
    losses, states = [], []
    for _ in range(2):
        torch.manual_seed(0)
        model = MarkovClassifier(num_classes=15, dropout=0.0, **SMALL)
        model.keep_high.fps_random_start = True
        state = create_train_state(model, cfg, torch.device("cpu"))
        state.fps_generator = torch.Generator().manual_seed(9)
        before = state.fps_generator.get_state().clone()
        losses.append(float(make_cls_train_step(cfg, 4)(state, x, y)))
        assert not torch.equal(state.fps_generator.get_state(), before)
        states.append(state.model.state_dict())
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.parametrize("xyz_mode", [True, False])
def test_local_trans_use_tanh_matches_mpa_tpu(xyz_mode):
    B, N, S, K, C_out = 2, 32, 12, 8, 16
    C_in = 3 if xyz_mode else 10
    source = _x(13, (B, N, C_in))
    center = source[:, :S]
    idx = np.random.default_rng(14).integers(0, N, (B, S, K)).astype(np.int32)
    jm = JaxLocalTrans(C_out, K, residual_proj=True, use_tanh=True)
    args = (jnp.asarray(source), jnp.asarray(center), jnp.asarray(idx))
    flat = jax_variables(jm, *args, xyz_mode=xyz_mode)

    def jloss(params, src):
        out = jm.apply({"params": params, "batch_stats": _nest(flat)["batch_stats"]}, src,
                       src[:, :S], args[2], xyz_mode=xyz_mode, train=False)
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        _nest(flat)["params"], args[0])
    tm, unused = port(LocalTrans(C_in, C_out, K, residual_proj=True, use_tanh=True), flat)
    assert unused == []
    src = torch.from_numpy(source).requires_grad_(True)
    got = tm(src, src[:, :S], torch.from_numpy(idx), xyz_mode=xyz_mode)
    (got * torch.cos(got)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(src.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    want_grads = _grads_to_port({"params/" + "/".join(p.key for p in path): np.asarray(v)
                                 for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]},
                                tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert float(tm.q.weight.grad.abs().sum()) > 0  # q is live on this path


@pytest.mark.parametrize("xyz_branch", [False, True])
def test_local_merge_use_tanh_matches_mpa_tpu(xyz_branch):
    B, N, S, C_in, C_out = 2, 64, 24, 12, 16
    base_xyz, feats = _x(15, (B, N, 3)), _x(16, (B, N, C_in))
    fps_idx = np.stack([np.random.default_rng(17 + b).permutation(N)[:S]
                        for b in range(B)]).astype(np.int32)
    xyz = np.take_along_axis(base_xyz, fps_idx[..., None], 1)
    jm = JaxLocalMerge(C_out, 8, residual=True, use_tanh=True, include_xyz_branch=xyz_branch)
    jargs = (jnp.asarray(xyz), jnp.asarray(base_xyz))

    def jloss(params, f):
        out, _, _ = jm.apply({"params": params, "batch_stats": _nest(flat)["batch_stats"]},
                             *jargs, feature=f, fps_idx=jnp.asarray(fps_idx), train=False)
        return jnp.sum(out * jnp.cos(out)), out

    flat = jax_variables(jm, *jargs, feature=jnp.asarray(feats), fps_idx=jnp.asarray(fps_idx))
    (_, want), gf = jax.value_and_grad(jloss, argnums=1, has_aux=True)(
        _nest(flat)["params"], jnp.asarray(feats))
    tm, unused = port(LocalMerge(C_in, C_out, 8, residual=True, use_tanh=True,
                                 include_xyz_branch=xyz_branch), flat)
    assert unused == []
    f = torch.from_numpy(feats).requires_grad_(True)
    got, _, _ = tm(torch.from_numpy(xyz), torch.from_numpy(base_xyz), feature=f,
                   fps_idx=torch.from_numpy(fps_idx))
    (got * torch.cos(got)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf), rtol=1e-4, atol=1e-5)


def test_layer_norm_linear_unit_matches_mpa_tpu_and_the_fixture():
    """The reference's ``norm1`` site: the fixture's frozen torch output and
    ``mpa_tpu``'s ``LinearUnit(norm="layer")`` (flax's one-pass variance, the
    port's two-pass one), and the input gradient."""
    f = oracle("nn_linear_unit_layer", None)
    tm, unused = port(LinearUnit(16, 32, norm="layer"),
                      {k: v for k, v in f.items() if k.startswith("variables/")})
    assert unused == [] and isinstance(tm.norm, torch.nn.LayerNorm)
    x = torch.from_numpy(f["x"]).requires_grad_(True)
    got = tm(x)
    np.testing.assert_allclose(got.detach().numpy(), f["want"], atol=1e-5)
    jm = JaxLinearUnit(32, norm="layer")
    params = subtree(f, "variables/params")

    def jfn(a):
        return jm.apply({"params": params}, a, train=False)

    jx = jnp.asarray(f["x"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jfn(jx)), rtol=1e-5, atol=1e-5)
    gx = jax.grad(lambda a: jnp.sum(jnp.sin(jfn(a))))(jx)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="norm"):
        LinearUnit(4, 4, norm="group")


def test_mi_aux_loss_matches_mpa_tpu():
    rets = [_x(20 + i, (3, 2 * (5 + i))) * 3.0 for i in range(3)]
    want, want_grads = jax.value_and_grad(
        lambda a, b, c: jax_mi_aux_loss(a, b, c), argnums=(0, 1, 2))(*map(jnp.asarray, rets))
    ts = [torch.from_numpy(r).requires_grad_(True) for r in rets]
    got = mi_aux_loss(*ts)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for t, g in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)


# -- the constructor options ----------------------------------------------------------


def jit_variables(module, x):
    """``jax_variables`` of a whole model from a jitted init (the eager one
    takes 20-30 s for these two)."""
    variables = jax.jit(lambda r, a: module.init(r, a, train=False))(jax.random.key(0), x)
    flat = {"/".join(p.key for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(dict(variables))[0]}
    rng = np.random.default_rng(0)
    for key, v in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            flat[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[key] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return flat


def _stats_close(tm, upd, names):
    for bn in names:
        stats = upd["batch_stats"]
        for part in bn.split("."):
            stats = stats[part]
        mod = tm.get_submodule(bn)
        np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,channels,aggr,return_dist,random_inv,train", [
    (5, 12, "max", False, True, True),  # 9 channels a triangle, flips from the key
    (7, 16, "avg", True, False, True),  # no inversion: neither flips nor a generator needed
    (5, 12, "sum", False, True, False),
])
def test_umbrella_constructor_options_match_mpa_tpu(k, channels, aggr, return_dist,
                                                    random_inv, train):
    x = _x(30 + k, (3, 40, 3))
    kw = dict(k=k, channels=channels, aggr_type=aggr, return_dist=return_dist,
              random_inv=random_inv)
    jm = JaxUmbrella(**kw)
    flat = jax_variables(jm, jnp.asarray(x))
    assert flat["params/mlp0/kernel"].shape == (10 if return_dist else 9, channels)
    tm, unused = port(UmbrellaSurfaceConstructor(**kw), flat)
    assert unused == []
    if not train:
        want = jm.apply(_nest(flat), jnp.asarray(x), train=False)
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        return
    key = jax.random.key(k)
    want, upd = jm.apply(_nest(flat), jnp.asarray(x), train=True, rng=key, mutable=["batch_stats"])
    flips = None
    if random_inv:
        flips = torch.from_numpy(
            np.asarray(jax.random.randint(key, (3,), 0, 2)).astype(np.float32) * 2.0 - 1.0)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), flips=flips)
    assert tuple(got.shape) == (3, 40, channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _stats_close(tm, upd, ("bn0", "bn1"))


@pytest.mark.parametrize("pos_channel,polar,normal,group_all,train", [
    (3, False, False, False, False),  # offsets only; the features without the normals
    (3, True, True, False, True),  # the polar channels on the feature side of the split
    (4, True, False, True, False),  # the whole cloud, split inside the polar channels
])
def test_surface_abstraction_cd_options_match_mpa_tpu(pos_channel, polar, normal, group_all,
                                                      train):
    center, nrm, feature = _sa_inputs(23, feat=12)
    kw = dict(npoint=0 if group_all else 32, radius=0.0 if group_all else 0.2,
              nsample=0 if group_all else 24, group_all=group_all, return_polar=polar,
              return_normal=normal)
    jm = JaxSACD(pos_channel=pos_channel, mlp=(16, 24), **kw)
    jargs = (jnp.asarray(center), jnp.asarray(nrm), jnp.asarray(feature))
    flat = jax_variables(jm, *jargs)
    tm, unused = port(SurfaceAbstractionCD(in_channel=(10 if normal else 0) + 12, mlp=(16, 24),
                                           pos_channel=pos_channel, **kw), flat)
    assert unused == [] and tm.mlp_l0.in_features == pos_channel
    targs = (torch.from_numpy(center), torch.from_numpy(nrm), torch.from_numpy(feature))
    if train:
        (_, _, want), upd = jm.apply(_nest(flat), *jargs, train=True, mutable=["batch_stats"])
        tm.train()
    else:
        _, _, want = jm.apply(_nest(flat), *jargs, train=False)
    with torch.no_grad():
        _, _, got = tm(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4 if train else 1e-5)
    if train:
        _stats_close(tm, upd, ("bn_l0", "bn_f0"))


def test_markov_cls_umbrella_options_match_mpa_tpu():
    """``use_umbrella`` with ``umbrella_k=5`` and a max over the fan, in
    train mode (the umbrella runs there only), dropout 0: the log-probs
    within 1e-4 (train-mode BatchNorm over four clouds, float32 sums in
    another order) and the umbrella's updated statistics within 1e-5, the
    normal flips those ``mpa_tpu`` draws from the key it is given."""
    B, N = 4, 128
    x = _x(40, (B, N, 3))
    kw = dict(num_classes=10, use_umbrella=True, umbrella_k=5, umbrella_aggr="max",
              dropout=0.0, npoints=SMALL["npoints"], channels=SMALL["channels"],
              encoder_features=SMALL["encoder_features"])
    jm = JaxMarkovClassifier(**kw)
    flat = jit_variables(jm, jnp.asarray(x))
    assert flat["params/surface_constructor/mlp0/kernel"].shape == (10, 10)
    want, upd = jax.jit(lambda v, a: jm.apply(v, a, train=True, rng=KEY, mutable=["batch_stats"]))(
        _nest(flat), jnp.asarray(x))
    flips = np.asarray(jax.random.randint(KEY, (B,), 0, 2)).astype(np.float32) * 2.0 - 1.0
    tm, unused = port(MarkovClassifier(**kw), flat)
    assert unused == [] and (tm.surface_constructor.k, tm.surface_constructor.aggr_type) == (
        5, "max")
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), flips=torch.from_numpy(flips))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    _stats_close(tm, upd, ("surface_constructor.bn0", "surface_constructor.bn1"))


def test_repsurf_umbrella_and_polar_options_match_mpa_tpu():
    """Eval log-probs of ``RepSurfSSG2x(umbrella_k=5, umbrella_aggr="avg",
    return_dist=False, return_polar=False)`` at ``test_torch_port_repsurf``'s
    small size, within 1e-4."""
    x = _x(41, (2, 128, 3)) * np.float32(0.2)
    kw = dict(num_classes=15, umbrella_k=5, umbrella_aggr="avg", return_dist=False,
              return_polar=False, **REPSURF_SMALL)
    jm = JaxRepSurf(**kw)
    flat = jit_variables(jm, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, p: jm.apply(v, p, train=False))(_nest(flat),
                                                                          jnp.asarray(x)))
    tm, unused = port(RepSurfSSG2x(**kw), flat)
    assert unused == [] and tm.sa1.mlp_l0.in_features == 3
    assert tm.surface_constructor.mlp0.in_features == 9
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_feature_propagation_dtype_matches_mpa_tpu():
    """``PointNetFeaturePropagation(dtype=torch.bfloat16)``: ``conv`` in
    ``LinearUnit``'s mixed precision form, eval mode, against ``mpa_tpu``'s
    ``dtype=jnp.bfloat16`` run eagerly (so XLA keeps every bf16 rounding)."""
    rng = np.random.default_rng(42)
    B, n, S, C, out = 2, 48, 16, 12, 8
    fine, coarse, feats = (rng.standard_normal(s).astype(np.float32)
                           for s in ((B, n, 3), (B, S, 3), (B, S, C)))
    jm = JaxFeaturePropagation(out, dtype=jnp.bfloat16)
    flat = jax_variables(jm, jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(feats))
    want = jm.apply(_nest(flat), jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(feats),
                    train=False)
    tm, unused = port(PointNetFeaturePropagation(C, out, dtype=torch.bfloat16), flat)
    assert unused == [] and tm.conv.dtype == torch.bfloat16
    with torch.inference_mode():
        got = tm(torch.from_numpy(fine), torch.from_numpy(coarse), torch.from_numpy(feats))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(want).max()))
