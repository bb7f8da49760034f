"""Port parity, markov_partseg inference, on the CPU.

Each new ``mpa_tpu_torch`` piece of the part-seg path against its ``mpa_tpu``
twin on the same numpy inputs, with the JAX variables carried across by
``from_jax_variables``, eval mode, narrow widths: the scatter-mean upsample
(forward and gradient, with a slot that one coarse point names twice and
slots nobody claims), ``LinearUnit`` with ``mid_op``, the three part-seg
forms of ``LocalMerge``, ``compose_fps_chain``, ``Fuse`` toward every target,
the whole model, and ``load_segmenter``; and the same pieces against the
frozen torch-oracle fixtures of the reference implementation. ``mpa_tpu``
runs as its own tests run it on the CPU (``scatter_mean_upsample`` takes its
``segment_sum`` form there, ``transition_attention`` its XLA reference); the
port takes its plain ops, because the tensors lie on the CPU. The kernel
itself is held against the plain version on the card
(``tests/test_torch_port_cuda.py``).

Tolerances: 1e-6 absolute for the scatter-mean (a sum of at most S*K float32
terms and one divide on both sides); 1e-5 for single blocks, as in
``test_torch_port_cls.py``; 1e-4 for the whole model against ``mpa_tpu`` and
5e-4 against the frozen oracle (the bounds of ``test_partseg_model_parity.py``,
whose 3e-5 and 5e-5 for the blocks are kept too).
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
from test_torch_port_cls import _nest, _x, jax_variables, port, state_to_flax  # noqa: E402

from mpa_tpu import ops as jops  # noqa: E402
from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu.nn import Fuse as JaxFuse  # noqa: E402
from mpa_tpu.nn import LinearUnit as JaxLinearUnit  # noqa: E402
from mpa_tpu.nn import LocalMerge as JaxLocalMerge  # noqa: E402
from mpa_tpu.nn.fuse import compose_fps_chain as jax_compose_fps_chain  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.models import MarkovPartSeg, get_model, list_models  # noqa: E402
from mpa_tpu_torch.nn import Fuse, LinearUnit, LocalMerge, compose_fps_chain  # noqa: E402
from mpa_tpu_torch.nn.keephigh_partseg import KeepHighResolutionPartSeg  # noqa: E402
from mpa_tpu_torch.ops import scatter_mean_upsample  # noqa: E402
from mpa_tpu_torch.ops.scatter import scatter_mean_plain  # noqa: E402
from mpa_tpu_torch.serve import load_classifier, load_segmenter  # noqa: E402


def _fixture(name):
    return oracle(name, lambda: pytest.fail(f"fixture {name}.npz missing"))


def _variables(f):
    return {k: v for k, v in f.items() if k.startswith("variables/")}


# -- the scatter-mean upsample -----------------------------------------------------


def _scatter_inputs(B, S, K, N, C, seed):
    """Features and indices with slot 1 named twice by coarse point 0 and
    slots N-3.. claimed by nobody."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, S, C)).astype(np.float32)
    idx = rng.integers(0, N - 3, (B, S, K)).astype(np.int32)
    idx[:, 0, 0] = 1
    idx[:, 0, K - 1] = 1
    return feats, idx


SCATTER_SHAPES = [(2, 16, 8, 32, 12), (3, 7, 4, 50, 5), (1, 40, 1, 9, 3), (2, 64, 8, 16, 1)]


@pytest.mark.parametrize("B,S,K,N,C", SCATTER_SHAPES)
def test_scatter_mean_matches_mpa_tpu(B, S, K, N, C):
    feats, idx = _scatter_inputs(B, S, K, N, C, seed=S)
    want = np.asarray(jops.scatter_mean_upsample(jnp.asarray(feats), jnp.asarray(idx), N))
    got = scatter_mean_upsample(torch.from_numpy(feats), torch.from_numpy(idx), N)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, N, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got.numpy()[:, N - 3:] == 0).all()  # unclaimed slots stay zero
    _, count = scatter_mean_plain(torch.from_numpy(feats), torch.from_numpy(idx), N)
    assert float(count.sum()) == B * S * K and (count[:, N - 3:] == 0).all()
    if K > 1:  # coarse point 0 counts twice in slot 1
        others = int((idx[0, 1:] == 1).sum())
        assert float(count[0, 1]) == 2 + others


@pytest.mark.parametrize("B,S,K,N,C", SCATTER_SHAPES)
def test_scatter_mean_grad_matches_mpa_tpu(B, S, K, N, C):
    feats, idx = _scatter_inputs(B, S, K, N, C, seed=S + 1)
    w = _x(S, (B, N, C))
    want = jax.grad(lambda f: jnp.sum(
        jops.scatter_mean_upsample(f, jnp.asarray(idx), N) * w))(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    (scatter_mean_upsample(f, torch.from_numpy(idx), N) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # The closed form the CUDA backward computes: gather g / max(count, 1), sum over K.
    _, count = scatter_mean_plain(torch.from_numpy(feats), torch.from_numpy(idx), N)
    g_norm = w / np.maximum(count.numpy(), 1.0)[..., None]
    picked = np.take_along_axis(g_norm, idx.reshape(B, S * K, 1).astype(np.int64), 1)
    np.testing.assert_allclose(picked.reshape(B, S, K, C).sum(2), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_scatter_mean_matches_frozen_oracle():
    f = _fixture("partseg_upsample")
    got = scatter_mean_upsample(torch.from_numpy(f["feats"]), torch.from_numpy(f["idx"]),
                                int(f["n_out"]))
    np.testing.assert_allclose(got.numpy(), f["want"], rtol=0, atol=1e-6)


def test_scatter_mean_checks_and_out_of_range():
    feats = torch.ones((1, 4, 2))
    idx = torch.tensor([[[0, 9], [0, -1], [2, 2], [5, 0]]], dtype=torch.int32)
    out, count = scatter_mean_plain(feats, idx, 4)  # 9, -1 and 5 claim nothing
    assert count.tolist() == [[3.0, 0.0, 2.0, 0.0]]
    assert out[0, :, 0].tolist() == [1.0, 0.0, 1.0, 0.0]
    with pytest.raises(ValueError, match="knn_idx"):
        scatter_mean_upsample(feats, idx[:, :3], 4)
    with pytest.raises(ValueError, match="integer"):
        scatter_mean_upsample(feats, idx.float(), 4)
    half = scatter_mean_upsample(feats.double(), idx.long(), 4)
    assert half.dtype == torch.float64  # the caller's dtype comes back


# -- LinearUnit with a hoisted row mix ----------------------------------------------


def test_linear_unit_mid_op():
    B, S, K, N = 2, 12, 4, 24
    x = _x(0, (B, S, 6))
    _, idx = _scatter_inputs(B, S, K, N, 1, seed=3)
    jm = JaxLinearUnit(10)
    flat = jax_variables(jm, jnp.asarray(x))
    want = jm.apply(_nest(flat), jnp.asarray(x), train=False,
                    mid_op=lambda y: jops.scatter_mean_upsample(y, jnp.asarray(idx), N))
    tm, _ = port(LinearUnit(6, 10), flat)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 mid_op=lambda y: scatter_mean_upsample(y, torch.from_numpy(idx), N))
        bias_rows = tm(torch.zeros((1, 1, 6)), mid_op=lambda y: torch.zeros_like(y))
    assert tuple(got.shape) == (B, N, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # Unclaimed rows come out as act(norm(bias)), the rows a zero mid_op gives.
    np.testing.assert_allclose(got.numpy()[:, N - 1], np.broadcast_to(bias_rows[0, 0], (B, 10)),
                               rtol=0, atol=1e-6)


# -- LocalMerge's part-seg forms ------------------------------------------------------


def _merge_inputs(B, N, S, C_in, seed):
    base_xyz = _x(seed, (B, N, 3))
    feats = _x(seed + 1, (B, N, C_in))
    fps_idx = np.stack([np.random.default_rng(seed + 2 + b).permutation(N)[:S]
                        for b in range(B)]).astype(np.int32)
    xyz = np.take_along_axis(base_xyz, fps_idx[..., None], 1)
    return base_xyz, feats, fps_idx, xyz


@pytest.mark.parametrize("residual", [False, True])
def test_local_merge_xyz_branch_transition(residual):
    """The encoder's form: three branches, the xyz and spatial ones packed
    into one two-branch attention call."""
    B, N, S, C_out = 2, 64, 24, 16
    C_in = 12 if residual else C_out
    base_xyz, feats, fps_idx, xyz = _merge_inputs(B, N, S, C_in, seed=10)
    jm = JaxLocalMerge(C_out, 8, residual=residual, include_xyz_branch=True)
    jargs = (jnp.asarray(xyz), jnp.asarray(base_xyz))
    jkw = dict(feature=jnp.asarray(feats), fps_idx=jnp.asarray(fps_idx))
    flat = jax_variables(jm, *jargs, **jkw)
    want, widx, _ = jm.apply(_nest(flat), *jargs, train=False, **jkw)
    tm, unused = port(LocalMerge(C_in, C_out, 8, residual=residual, include_xyz_branch=True),
                      flat)
    assert unused == []
    with torch.no_grad():
        got, gidx, _ = tm(torch.from_numpy(xyz), torch.from_numpy(base_xyz),
                          feature=torch.from_numpy(feats), fps_idx=torch.from_numpy(fps_idx))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_local_merge_self_attention_reuses_spatial_knn():
    """The decoder's form: ``xyz == base_xyz``, no FPS index, and the spatial
    kNN handed in instead of searched."""
    B, N, C = 2, 48, 16
    xyz = _x(20, (B, N, 3))
    feats = _x(21, (B, N, C))
    dist, idx = jops.knn(8, jnp.asarray(xyz), jnp.asarray(xyz))
    jm = JaxLocalMerge(C, 8, residual=False, include_xyz_branch=True)
    jargs = (jnp.asarray(xyz), jnp.asarray(xyz))
    flat = jax_variables(jm, *jargs, feature=jnp.asarray(feats))
    want, _, _ = jm.apply(_nest(flat), *jargs, feature=jnp.asarray(feats), train=False,
                          spatial_knn=(dist, idx))
    tm, unused = port(LocalMerge(C, C, 8, include_xyz_branch=True), flat)
    assert unused == []
    given = (torch.from_numpy(np.array(dist)), torch.from_numpy(np.array(idx)))
    with torch.no_grad():
        got, gidx, gdist = tm(torch.from_numpy(xyz), torch.from_numpy(xyz),
                              feature=torch.from_numpy(feats), spatial_knn=given)
        searched, sidx, _ = tm(torch.from_numpy(xyz), torch.from_numpy(xyz),
                               feature=torch.from_numpy(feats))
    assert gidx is given[1] and gdist is given[0]  # taken as is, not searched again
    np.testing.assert_array_equal(sidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(searched.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_local_merge_single_branch():
    B, N, S, C_in, C_out = 2, 64, 24, 12, 16
    base_xyz, feats, fps_idx, xyz = _merge_inputs(B, N, S, C_in, seed=30)
    jm = JaxLocalMerge(C_out, 8, residual=True, single_branch=True)
    jargs = (jnp.asarray(xyz), jnp.asarray(base_xyz))
    jkw = dict(feature=jnp.asarray(feats), fps_idx=jnp.asarray(fps_idx))
    flat = jax_variables(jm, *jargs, **jkw)
    want, _, _ = jm.apply(_nest(flat), *jargs, train=False, **jkw)
    tm, unused = port(LocalMerge(C_in, C_out, 8, residual=True, single_branch=True), flat)
    assert unused == [] and not hasattr(tm, "fc2") and not hasattr(tm, "feature_trans2")
    with torch.no_grad():
        got, _, _ = tm(torch.from_numpy(xyz), torch.from_numpy(base_xyz),
                       feature=torch.from_numpy(feats), fps_idx=torch.from_numpy(fps_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_local_merge_first_state_with_xyz_branch_has_one_trans():
    xyz = _x(3, (2, 48, 3))
    jm = JaxLocalMerge(16, 8, residual=True, include_xyz_branch=True)
    flat = jax_variables(jm, jnp.asarray(xyz), jnp.asarray(xyz))
    want, _, _ = jm.apply(_nest(flat), jnp.asarray(xyz), jnp.asarray(xyz), train=False)
    tm, unused = port(LocalMerge(None, 16, 8, residual=True, include_xyz_branch=True), flat)
    assert unused == [] and {n for n, _ in tm.named_children()} == {"xyz_trans"}
    with torch.no_grad():
        got, _, _ = tm(torch.from_numpy(xyz), torch.from_numpy(xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_local_merge_matches_frozen_oracle():
    f = _fixture("partseg_localmerge")
    tm, unused = port(LocalMerge(64, 128, 8, residual=True, include_xyz_branch=True),
                      _variables(f))
    assert unused == []
    with torch.no_grad():
        got, _, _ = tm(torch.from_numpy(f["xyz"]), torch.from_numpy(f["base_xyz"]),
                       feature=torch.from_numpy(f["feature"]),
                       fps_idx=torch.from_numpy(f["fps_idx"]))
    np.testing.assert_allclose(got.numpy(), f["want"], atol=3e-5)


@pytest.mark.parametrize("kw", [dict(use_tanh=True), dict(knn_mode="window"),
                                dict(feature_knn_mode="window")])
def test_unported_local_merge_modes_raise(kw):
    """``use_tanh`` is ported (held against ``mpa_tpu`` in
    ``tests/test_torch_port_model_options.py``) and reaches every branch; the
    window modes are ported (held against ``mpa_tpu`` in
    ``tests/test_torch_port_semseg.py``) and an unknown mode raises
    instead."""
    if "use_tanh" in kw:
        merge = LocalMerge(16, 16, 8, include_xyz_branch=True, **kw)
        assert all(t.use_tanh for t in (merge.xyz_trans, merge.feature_trans,
                                        merge.feature_trans2))
        return
    (key, mode), = kw.items()
    assert getattr(LocalMerge(16, 16, 8, **kw), key) == mode
    with pytest.raises(ValueError, match=key):
        LocalMerge(16, 16, 8, **{key: "ball"})


# -- Fuse ---------------------------------------------------------------------------


def _ladder(sizes, channels, seed):
    """Positions, features, FPS indices and the stored kNN of a small ladder,
    made with ``mpa_tpu``'s ops so both sides see the same indices."""
    rng = np.random.default_rng(seed)
    B = 2
    xyz = [rng.standard_normal((B, sizes[0], 3)).astype(np.float32)]
    fps, knn_idx = [], [None]
    for n in sizes[1:]:
        fi = np.asarray(jops.farthest_point_sample(jnp.asarray(xyz[-1]), n))
        nxt = np.take_along_axis(xyz[-1], fi[..., None].astype(np.int64), 1)
        _, ki = jops.knn(8, jnp.asarray(xyz[-1]), jnp.asarray(nxt))
        fps.append(fi.astype(np.int32))
        knn_idx.append(np.asarray(ki).astype(np.int32))
        xyz.append(nxt)
    feats = [rng.standard_normal((B, n, c)).astype(np.float32) for n, c in zip(sizes, channels)]
    return xyz, feats, fps, knn_idx


@pytest.mark.parametrize("dst", [1, 2, 3, 4])
def test_compose_fps_chain_matches_mpa_tpu(dst):
    _, _, fps, _ = _ladder((64, 32, 16, 8, 4), (4,) * 5, seed=1)
    for src in range(dst):
        want = jax_compose_fps_chain([jnp.asarray(f) for f in fps], src, dst)
        got = compose_fps_chain([torch.from_numpy(f) for f in fps], src, dst)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        compose_fps_chain([torch.from_numpy(f) for f in fps], dst, dst)


@pytest.mark.parametrize("target", [0, 1, 2, 3, 4])
def test_fuse_matches_mpa_tpu(target):
    sizes, ch = (64, 32, 16, 8, 4), (8, 8, 8, 16, 32)
    xyz, feats, fps, knn_idx = _ladder(sizes, ch, seed=3)
    j = lambda xs: [None if x is None else jnp.asarray(x) for x in xs]  # noqa: E731
    t = lambda xs: [None if x is None else torch.from_numpy(x) for x in xs]  # noqa: E731
    jm = JaxFuse(ch, num_neighbors=8)
    flat = jax_variables(jm, target, j(feats), j(fps), j(knn_idx), j(xyz), seed=target)
    want = jm.apply(_nest(flat), target, j(feats), j(fps), j(knn_idx), j(xyz), train=False)
    tm, unused = port(Fuse(ch, target, 8), flat)
    assert unused == []
    assert {n for n, _ in tm.named_children()} == (
        {f"conv{s}{target}" for s in range(5) if s != target} | {f"conv{target}"})
    with torch.no_grad():
        got = tm(t(feats), t(fps), t(knn_idx), t(xyz))
    for s in range(5):  # only the target's slot is refreshed
        if s != target:
            np.testing.assert_array_equal(np.asarray(want[s]), feats[s])
    np.testing.assert_allclose(got.numpy(), np.asarray(want[target]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("target", [0, 2, 4])
def test_fuse_matches_frozen_oracle(target):
    f = _fixture(f"partseg_fuse_t{target}")
    feats = [torch.from_numpy(f[f"feats/{i}"]) for i in range(5)]
    fps = [torch.from_numpy(f[f"fps/{i}"]) for i in range(4)]
    knn_idx = [None] + [torch.from_numpy(f[f"knn_idx/{i}"]) for i in range(4)]
    xyz = [torch.from_numpy(f[f"xyz/{i}"]) for i in range(5)]
    tm, unused = port(Fuse((64, 64, 64, 128, 256), target, 8), _variables(f))
    assert unused == []
    with torch.no_grad():
        got = tm(feats, fps, knn_idx, xyz)
    np.testing.assert_allclose(got.numpy(), f["want"], atol=5e-5)


def test_fuse_window_mode_raises():
    """The window mode is ported (``tests/test_torch_port_semseg.py``); an
    unknown mode raises."""
    assert Fuse((8, 8, 8, 16, 32), 0, knn_mode="window").knn_mode == "window"
    with pytest.raises(ValueError, match="knn_mode"):
        Fuse((8, 8, 8, 16, 32), 0, knn_mode="ball")


# -- the whole model -----------------------------------------------------------------

LADDER = (128, 64, 32, 16)  # the frozen oracles' ladder for 256-point clouds
NARROW = dict(npoints=LADDER, channels=(16, 16, 16, 32, 32))


def _seg_inputs(seed, B=2, N=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    onehot = np.eye(16, dtype=np.float32)[rng.integers(0, 16, B)]
    return x, onehot


def test_markov_partseg_matches_mpa_tpu():
    x, onehot = _seg_inputs(7)
    jm = JaxMarkovPartSeg(**NARROW)
    flat = jax_variables(jm, (jnp.asarray(x), jnp.asarray(onehot)))
    want = np.asarray(jax.jit(lambda v, p, o: jm.apply(v, (p, o), train=False))(
        _nest(flat), jnp.asarray(x), jnp.asarray(onehot)))
    tm, unused = port(MarkovPartSeg(**NARROW), flat)
    assert unused == []
    with torch.inference_mode():
        got = tm((torch.from_numpy(x), torch.from_numpy(onehot))).numpy()
    assert got.shape == (2, 256, 50) and np.isfinite(got).all()
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_markov_partseg_matches_frozen_torch_oracle():
    """The reference torch model's per-point log-probs, frozen in
    tests/fixtures (built by tests/torch_side/partseg_model.py), at full
    width on the ladder ``test_partseg_model_parity.py`` uses."""
    f = _fixture("partseg_model_forward")
    tm, unused = port(MarkovPartSeg(npoints=LADDER), _variables(f))
    assert unused == []  # every leaf of the checkpoint has a home, strictly
    assert tm.keep_high.out_channels == 896
    with torch.inference_mode():
        got = tm((torch.from_numpy(f["x_logits"]), torch.from_numpy(f["onehot_logits"]))).numpy()
        pred = tm((torch.from_numpy(f["x_pred"]), torch.from_numpy(f["onehot_pred"]))).numpy()
    np.testing.assert_allclose(got, f["want_logits"], atol=5e-4)
    np.testing.assert_array_equal(pred.argmax(-1), f["want_pred"].argmax(-1))


def test_partseg_registry_and_unported_options():
    assert "markov_partseg" in list_models() and "markov_cls" in list_models()
    assert isinstance(get_model("markov_partseg", npoints=LADDER), MarkovPartSeg)
    for mode in ("window", "window_all"):  # ported: tests/test_torch_port_window.py
        assert MarkovPartSeg(neighbor_mode=mode).keep_high.neighbor_mode == mode
    with pytest.raises(ValueError, match="neighbor_mode"):
        MarkovPartSeg(neighbor_mode="ball")
    # Mixed precision is ported in every neighbour mode (tests/test_torch_port_bf16.py,
    # tests/test_torch_port_bf16_window.py); any other compute dtype is refused.
    assert MarkovPartSeg(compute_dtype=torch.bfloat16).keep_high.la0.xyz_trans.dtype == torch.bfloat16
    for mode in ("window", "window_all"):
        model = MarkovPartSeg(compute_dtype=torch.bfloat16, neighbor_mode=mode)
        assert model.keep_high.neighbor_mode == mode
        assert model.keep_high.la1.feature_trans.dtype == torch.bfloat16
        keep = KeepHighResolutionPartSeg(dtype=torch.bfloat16, neighbor_mode=mode)
        assert keep.fuse1.conv4.dtype == torch.bfloat16
        for dt in (torch.float16, torch.float32):
            with pytest.raises(ValueError, match="compute_dtype"):
                MarkovPartSeg(compute_dtype=dt, neighbor_mode=mode)
    # Keyed FPS starts are ported: the forward takes them in train mode
    # (tests/test_torch_port_model_options.py), so no constructor switch.
    with pytest.raises(TypeError):
        KeepHighResolutionPartSeg(fps_random_start=True)
    with pytest.raises(ValueError):
        MarkovPartSeg(dropout=1.0)


# -- the serving entry point -----------------------------------------------------------


def test_load_segmenter_on_cpu():
    kernels.reset_launch_counts()
    seg = load_segmenter(device="cpu", seed=3)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 2048, 3)).astype(np.float32)
    cat = np.array([5])
    a = seg(x, cat)
    assert tuple(a.shape) == (1, 2048, 50) and torch.isfinite(a).all()
    torch.testing.assert_close(torch.exp(a).sum(-1), torch.ones(1, 2048))
    # The same seed gives the same weights; tensors are taken like arrays.
    b = load_segmenter(device="cpu", seed=3)(torch.from_numpy(x), torch.from_numpy(cat))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = seg(x, np.array([6]))  # the category reaches the output
    assert not torch.equal(a, other)
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only
    with pytest.raises(ValueError, match="category"):
        seg(x, np.array([16]))
    with pytest.raises(ValueError, match="category"):
        seg(x, np.array([1, 2]))
    with pytest.raises(ValueError, match="points"):
        seg(x[0], cat)


def test_load_segmenter_from_variables_and_preset_kinds():
    seg = load_segmenter(device="cpu", seed=1)
    seg2 = load_segmenter(variables=state_to_flax(seg.model.state_dict()), device="cpu")
    a, b = seg.model.state_dict(), seg2.model.state_dict()
    assert len(a) > 600 and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="partseg"):
        load_segmenter("scanobjectnn_cls", device="cpu")
    with pytest.raises(ValueError, match="cls"):
        load_classifier("shapenetpart", device="cpu")
    with pytest.raises(KeyError):
        load_segmenter("nope", device="cpu")


def test_segmenter_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_segmenter()
