"""Port parity, markov_semseg and the window modes of the blocks, on the CPU.

The window forms of ``LocalMerge`` and ``Fuse``, ``markov_semseg`` in its
three neighbour modes and ``load_semantic_segmenter``, each against its
``mpa_tpu`` twin on the same numpy
inputs with the JAX variables carried across by ``from_jax_variables``
(strictly: no key left over), eval mode, narrow widths. ``mpa_tpu`` runs as
its own tests run it on the CPU (the windowed kNN takes its jnp reference,
the windowed attention and scatter-mean their generic references); the port
takes its plain ops, because the tensors lie on the CPU.

Tolerances: 1e-5 for single blocks and 1e-4 for whole models against
``mpa_tpu``, the bounds of the part-seg tests. The seeds give inputs
without a near-tie that a last bit could flip: in exact mode the
feature-space kNN and the max over K amplify a last-bit difference between
XLA's sums and the port's into other neighbours at single points (one
point of 512 moved by 1.8e-2 at seed 0 of the exact model).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import _nest, _x, jax_variables, port, state_to_flax  # noqa: E402

from mpa_tpu import ops as jops  # noqa: E402
from mpa_tpu.models import MarkovSemSeg as JaxMarkovSemSeg  # noqa: E402
from mpa_tpu.nn import Fuse as JaxFuse  # noqa: E402
from mpa_tpu.nn import LocalMerge as JaxLocalMerge  # noqa: E402
from mpa_tpu.ops.pallas import window_attention as JWA  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.models import MarkovSemSeg, get_model, list_models  # noqa: E402
from mpa_tpu_torch.nn import Fuse, LocalMerge  # noqa: E402
from mpa_tpu_torch.nn.window_mode import spec_or_none  # noqa: E402
from mpa_tpu_torch.ops.morton import morton_sort  # noqa: E402
from mpa_tpu_torch.serve import load_segmenter, load_semantic_segmenter  # noqa: E402


def _sorted(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return morton_sort(torch.from_numpy(x))[0].numpy()


# -- LocalMerge's window forms ---------------------------------------------------------


def _merge_pair(B, N, S, C_in, seed):
    """A Morton-ordered fine set, its features, and a sorted stride subset
    (what sorted FPS gives) as the coarse centres."""
    base_xyz = _sorted(seed, (B, N, 3))
    feats = _x(seed + 1, (B, N, C_in))
    fps_idx = np.tile(np.arange(0, N, N // S, dtype=np.int32)[:S], (B, 1))
    xyz = np.take_along_axis(base_xyz, fps_idx[..., None].astype(np.int64), 1)
    return base_xyz, feats, fps_idx, xyz


# (N, S, feature_knn_mode): an encoder pair with both searches windowed, one
# with the feature search exact ('window'), and a pair that admits no window
# (S = 24: sq = 12 is no multiple of 8), which takes the exact searches.
MERGE_CASES = [(128, 64, "window"), (128, 64, "exact"), (64, 24, "window")]


@pytest.mark.parametrize("N,S,feature_mode", MERGE_CASES)
def test_local_merge_window_modes(N, S, feature_mode):
    B, C = 2, 16
    base_xyz, feats, fps_idx, xyz = _merge_pair(B, N, S, C, seed=N + S)
    kw = dict(include_xyz_branch=True, knn_mode="window", feature_knn_mode=feature_mode)
    jm = JaxLocalMerge(C, 8, residual=True, **kw)
    jargs = (jnp.asarray(xyz), jnp.asarray(base_xyz))
    jkw = dict(feature=jnp.asarray(feats), fps_idx=jnp.asarray(fps_idx))
    flat = jax_variables(jm, *jargs, **jkw)
    want, widx, wdist = jm.apply(_nest(flat), *jargs, train=False, **jkw)
    tm, unused = port(LocalMerge(C, C, 8, residual=True, **kw), flat)
    assert unused == []
    with torch.no_grad():
        got, gidx, gdist = tm(torch.from_numpy(xyz), torch.from_numpy(base_xyz),
                              feature=torch.from_numpy(feats), fps_idx=torch.from_numpy(fps_idx))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(gdist.numpy(), np.asarray(wdist), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    spec = spec_or_none(S, N)
    if spec is None:  # the exact semantics, as mpa_tpu takes them
        exact, eidx, _ = port(LocalMerge(C, C, 8, residual=True, include_xyz_branch=True),
                              flat)[0](torch.from_numpy(xyz), torch.from_numpy(base_xyz),
                                       feature=torch.from_numpy(feats),
                                       fps_idx=torch.from_numpy(fps_idx))
        assert torch.equal(eidx, gidx)
        torch.testing.assert_close(exact.detach(), got, rtol=0, atol=0)
    else:
        win0 = spec.window_start()[None, :, None]
        assert bool(((gidx >= win0) & (gidx < win0 + spec.window)).all())


def test_local_merge_window_first_state_and_reused_search():
    """The first state windowed, and the decoder's self-attention handed the
    windowed search of the same positions (its spec rebuilt from the
    shapes)."""
    B, N, C = 2, 128, 16
    xyz = _sorted(3, (B, N, 3))
    feats = _x(4, (B, N, C))
    kw = dict(include_xyz_branch=True, knn_mode="window", feature_knn_mode="window")
    jm0 = JaxLocalMerge(C, 8, residual=True, **kw)
    flat0 = jax_variables(jm0, jnp.asarray(xyz), jnp.asarray(xyz))
    want0, idx0, d0 = jm0.apply(_nest(flat0), jnp.asarray(xyz), jnp.asarray(xyz), train=False)
    tm0, unused = port(LocalMerge(None, C, 8, residual=True, **kw), flat0)
    assert unused == []
    with torch.no_grad():
        got0, gidx0, gd0 = tm0(torch.from_numpy(xyz), torch.from_numpy(xyz))
    np.testing.assert_array_equal(gidx0.numpy(), np.asarray(idx0))
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), rtol=1e-5, atol=1e-5)

    jm = JaxLocalMerge(C, 8, residual=False, **kw)
    jargs = (jnp.asarray(xyz), jnp.asarray(xyz))
    flat = jax_variables(jm, *jargs, feature=jnp.asarray(feats))
    want, _, _ = jm.apply(_nest(flat), *jargs, feature=jnp.asarray(feats), train=False,
                          spatial_knn=(d0, idx0))
    tm, _ = port(LocalMerge(C, C, 8, **kw), flat)
    with torch.no_grad():
        got, gidx, _ = tm(torch.from_numpy(xyz), torch.from_numpy(xyz),
                          feature=torch.from_numpy(feats), spatial_knn=(gd0, gidx0))
    assert gidx is gidx0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_local_merge_and_fuse_refuse_unknown_modes():
    for kw in (dict(knn_mode="ball"), dict(feature_knn_mode="ball")):
        with pytest.raises(ValueError, match="mode"):
            LocalMerge(16, 16, 8, **kw)
    with pytest.raises(ValueError, match="knn_mode"):
        Fuse((8,) * 5, 0, knn_mode="ball")
    with pytest.raises(ValueError, match="neighbor_mode"):
        MarkovSemSeg(neighbor_mode="windowed")


# -- Fuse in window mode ----------------------------------------------------------------------


def _window_ladder(sizes, channels, seed):
    """A Morton-ordered ladder as the window modes build it: sorted FPS
    subsets, and each scale's stored search into the next finer one
    windowed where the pair admits a window (exact otherwise), made with
    ``mpa_tpu``'s ops so both sides see the same indices."""
    rng = np.random.default_rng(seed)
    B = 2
    xyz = [_sorted(seed, (B, sizes[0], 3))]
    fps, knn_idx = [], [None]
    for n in sizes[1:]:
        fi = np.sort(np.asarray(jops.farthest_point_sample(jnp.asarray(xyz[-1]), n)), -1)
        nxt = np.take_along_axis(xyz[-1], fi[..., None].astype(np.int64), 1)
        if spec_or_none(n, xyz[-1].shape[1]) is not None:
            _, ki, _ = JWA.windowed_knn_with_spec(8, jnp.asarray(xyz[-1]), jnp.asarray(nxt))
        else:
            _, ki = jops.knn(8, jnp.asarray(xyz[-1]), jnp.asarray(nxt))
        fps.append(fi.astype(np.int32))
        knn_idx.append(np.asarray(ki).astype(np.int32))
        xyz.append(nxt)
    feats = [rng.standard_normal((B, n, c)).astype(np.float32) for n, c in zip(sizes, channels)]
    return xyz, feats, fps, knn_idx


@pytest.mark.parametrize("target", [0, 1, 2, 3, 4])
def test_fuse_window_mode_matches_mpa_tpu(target):
    """Adjacent coarser pairs over the stored index, non-adjacent ones over a
    fresh windowed search, the banded scatter-mean as the hoisted mid_op;
    the pairs (8, 16) and (4, 8) admit no window and take the exact ops."""
    sizes, ch = (128, 64, 32, 16, 8), (8, 8, 8, 16, 16)
    xyz, feats, fps, knn_idx = _window_ladder(sizes, ch, seed=target + 5)
    j = lambda xs: [None if x is None else jnp.asarray(x) for x in xs]  # noqa: E731
    t = lambda xs: [None if x is None else torch.from_numpy(x) for x in xs]  # noqa: E731
    jm = JaxFuse(ch, num_neighbors=8, knn_mode="window")
    flat = jax_variables(jm, target, j(feats), j(fps), j(knn_idx), j(xyz), seed=target)
    want = jm.apply(_nest(flat), target, j(feats), j(fps), j(knn_idx), j(xyz), train=False)
    tm, unused = port(Fuse(ch, target, 8, knn_mode="window"), flat)
    assert unused == []
    with torch.no_grad():
        got = tm(t(feats), t(fps), t(knn_idx), t(xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[target]), rtol=1e-5, atol=1e-5)


# -- the whole model ---------------------------------------------------------------------------

NARROW = dict(num_classes=5, npoints=(128, 64, 32, 16), channels=(8, 8, 8, 16, 16))


def _blocks(seed, B=2, N=256, F=6):
    return np.random.default_rng(seed).standard_normal((B, N, 3 + F)).astype(np.float32)


# (mode, feature_channels, extra): every mode with the block features, one
# without them, and window_all with band floors low enough that every
# encoder FPS really bands (pick_fps_bands > 1, as test_window_attention.py
# runs it).
MODEL_CASES = [("exact", 6, {}), ("window", 6, {}), ("window_all", 6, {}),
               ("window_all", 0, dict(fps_min_band=32, fps_min_samples=8))]


@pytest.mark.parametrize("mode,F,extra", MODEL_CASES)
def test_markov_semseg_matches_mpa_tpu(mode, F, extra):
    cfg = dict(NARROW, feature_channels=F, neighbor_mode=mode, **extra)
    x = _blocks(1, F=F)
    jm = JaxMarkovSemSeg(**cfg)
    flat = jax_variables(jm, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, p: jm.apply(v, p, train=False))(_nest(flat),
                                                                         jnp.asarray(x)))
    tm, unused = port(MarkovSemSeg(**cfg), flat)
    assert unused == []  # every leaf of the JAX model has a home, strictly
    assert (tm.feat_in is None) == (F == 0)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 256, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if extra:
        from mpa_tpu_torch.ops.fps import pick_fps_bands

        assert all(pick_fps_bands(n, n // 2, min_band=32, min_samples=8) > 1
                   for n in (256, 128, 64))


@pytest.mark.parametrize("mode", ["window", "window_all"])
def test_markov_semseg_window_modes_are_permutation_equivariant(mode):
    """The Morton sort makes the row order canonical (distinct codes here),
    so a permuted block gives exactly the permuted log-probs."""
    x = _blocks(2)
    perm = np.random.default_rng(3).permutation(256)
    model = MarkovSemSeg(**NARROW, neighbor_mode=mode).eval()
    with torch.inference_mode():
        a = model(torch.from_numpy(x))
        b = model(torch.from_numpy(np.ascontiguousarray(x[:, perm])))
    torch.testing.assert_close(b, a[:, perm], rtol=0, atol=0)


def test_markov_semseg_registry_and_options():
    assert "markov_semseg" in list_models()
    m = get_model("markov_semseg", npoints=(128, 64, 32, 16))
    assert isinstance(m, MarkovSemSeg) and m.neighbor_mode == "exact"
    with pytest.raises(ValueError):
        MarkovSemSeg(dropout=1.0)
    with pytest.raises(ValueError):
        MarkovSemSeg(npoints=(128, 64))


# -- the serving entry point ------------------------------------------------------------------


def test_load_semantic_segmenter_on_cpu():
    kernels.reset_launch_counts()
    seg = load_semantic_segmenter(device="cpu", seed=3, num_points=512,
                                  neighbor_mode="window_all")
    assert seg.model.neighbor_mode == "window_all" and seg.model.npoints == (256, 128, 64, 32)
    x = _blocks(9, B=1, N=512)
    a = seg(x)
    assert tuple(a.shape) == (1, 512, 13) and torch.isfinite(a).all()
    torch.testing.assert_close(torch.exp(a).sum(-1), torch.ones(1, 512))
    b = load_semantic_segmenter(device="cpu", seed=3, num_points=512,
                                neighbor_mode="window_all")(torch.from_numpy(x))
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # the same seed, the same weights
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only
    with pytest.raises(ValueError, match="points"):
        seg(x[..., :3])
    # Variables carried across strictly give the same outputs.
    seg2 = load_semantic_segmenter(variables=state_to_flax(seg.model.state_dict()),
                                   device="cpu", num_points=512, neighbor_mode="window_all")
    torch.testing.assert_close(seg2(x), a, rtol=0, atol=0)
    with pytest.raises(ValueError, match="semseg"):
        load_semantic_segmenter("shapenetpart", device="cpu")
    with pytest.raises(ValueError, match="partseg"):
        load_segmenter("s3dis_semseg", device="cpu")
    with pytest.raises(TypeError):
        load_semantic_segmenter(device="cpu", num_pointz=512)


def test_semantic_segmenter_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        load_semantic_segmenter()
