"""Port parity, the functions off every live path, on the CPU.

``mpa_tpu``'s RepSurf functions that no model runs (``convert_polar``,
``xyz2cylind``, ``cal_area``, ``check_nan``, ``knn_surface_features``,
``pca``), its plain ``SurfaceAbstraction``, the ops nothing calls
(``mod_index``, ``knn_self``, ``knn_point2``, ``inner_correlation``,
``random_sample``, ``shared_random_sample``), and the port's profile
breakdowns (``op_breakdown``, ``category_breakdown``), which read a
``torch.profiler`` profile where ``mpa_tpu``'s read an XSpace.

``mpa_tpu`` runs as its own tests run it (JAX on the CPU); the port takes
its plain ops, the tensors lying on the CPU. The random ops are held to
their contract, not stream for stream (torch cannot replay JAX's PRNG):
shapes, no repeats, one permutation shared by the batch, the rows taken;
``knn_point2``'s own match first at distance 0 and a coincident duplicate
not second. ``mod_index`` is tested without a repeated index: which write
lands is unspecified there on both sides.

Tolerances: the angles and coordinates within 1e-6 (the same float32
arithmetic, perhaps in another order), areas and the surface features
within 1e-5, the cosine Gram matrix within 1e-6, PCA's components up to
the sign of each column and its explained variance within 1e-5 relative,
the set abstraction's features within 1e-5 (1e-4 in train mode, as
``test_torch_port_repsurf.py`` holds ``SurfaceAbstractionCD``), the
indices, gathers and replaced rows exactly.
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)
from test_torch_port_cls import _nest, jax_variables, port  # noqa: E402
from test_torch_port_repsurf import _sa_inputs  # noqa: E402

from mpa_tpu import geometry as jgeo  # noqa: E402
from mpa_tpu import ops as jops  # noqa: E402
from mpa_tpu.nn.surface_abstraction import SurfaceAbstraction as JaxSA  # noqa: E402
from mpa_tpu_torch import geometry, kernels  # noqa: E402
from mpa_tpu_torch import ops  # noqa: E402
from mpa_tpu_torch.nn import SurfaceAbstraction  # noqa: E402
from mpa_tpu_torch.utils.profiling import (  # noqa: E402
    MATMUL, OTHER, category_breakdown, kernel_category, op_breakdown,
)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# -- geometry --------------------------------------------------------------------------


def test_convert_polar_matches_mpa_tpu():
    neigh, centre = _x(0, (2, 8, 5, 3)), _x(1, (2, 8, 1, 3))
    neigh[0, 0, 0] = centre[0, 0, 0]  # a zero offset: every atan2(0, 0)
    want = jgeo.convert_polar(jnp.asarray(neigh), jnp.asarray(centre))
    got = geometry.convert_polar(_t(neigh), _t(centre))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 8, 5)
        _close(g, w, atol=1e-6)
    # r_yz is sqrt(y^2 + z^2): x_beta is the elevation out of the yz plane.
    rel = neigh - centre
    _close(got[1], np.arctan2(rel[..., 0], np.hypot(rel[..., 1], rel[..., 2])), atol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
def test_xyz2cylind_matches_mpa_tpu(normalize):
    x = _x(2, (3, 40, 3), scale=0.8)
    x[0, 0] = 0.0
    _close(geometry.xyz2cylind(_t(x), normalize),
           jgeo.xyz2cylind(jnp.asarray(x), normalize), atol=1e-6)


def test_cal_area_matches_mpa_tpu():
    tri = _x(3, (2, 16, 3, 3))
    tri[0, 0, 2] = tri[0, 0, 1]  # a degenerate triangle: area 0
    got = geometry.cal_area(_t(tri))
    assert tuple(got.shape) == (2, 16, 1) and float(got[0, 0, 0]) == 0.0
    _close(got, jgeo.cal_area(jnp.asarray(tri)), atol=1e-5, rtol=1e-5)


def test_check_nan_matches_mpa_tpu():
    normal, center, pos = _x(4, (3, 10, 3)), _x(5, (3, 10, 3)), _x(6, (3, 10, 1))
    normal[0, [0, 1, 4]] = np.nan  # the cloud's first valid point is 2
    normal[1, 3] = 0.0  # a degenerate (zero) normal
    normal[2] = 0.0  # no valid point: every row takes point 0's
    want = jgeo.check_nan(*(jnp.asarray(a) for a in (normal, center, pos)))
    got = geometry.check_nan(_t(normal), _t(center), _t(pos))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1][0, 0].numpy(), center[0, 2])
    two = geometry.check_nan(_t(normal), _t(center))
    assert len(two) == 2 and torch.equal(two[0], got[0])


@pytest.mark.parametrize("return_dist,flip", [(False, False), (True, False), (True, True)])
def test_knn_surface_features_match_mpa_tpu(return_dist, flip):
    """The centres are context points, one of them repeated: its triangle
    has a zero edge (a zero normal, repaired on both sides). The centres
    whose triangle has two equal edges (the repeated point's neighbours)
    are left out, where ``mpa_tpu`` keeps a normal of rounding noise
    (``ROADMAP.md``, Queue 3; ``test_equal_edges_give_a_zero_normal``). With
    ``flip`` the train-time inversion: the signs ``mpa_tpu`` draws from its
    key, handed to the port."""
    context = _x(8, (2, 48, 3))
    context[:, 1] = context[:, 0]
    center = context[:, :32].copy()
    key = jax.random.key(4) if flip else None
    want = jgeo.knn_surface_features(jnp.asarray(center), jnp.asarray(context), k=3,
                                     return_dist=return_dist, random_inv_key=key)
    flips = None
    if flip:
        flips = _t(np.asarray(jax.random.randint(key, (2,), 0, 2)).astype(np.float32) * 2 - 1)
        assert (flips == -1).any()
    got = geometry.knn_surface_features(_t(center), _t(context), k=3, return_dist=return_dist,
                                        flips=flips)
    assert len(got) == (3 if return_dist else 2)
    _, idx = ops.knn(3, _t(context), _t(center))
    tri = ops.index_points(_t(context), idx)
    e1, e2 = tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :]
    noisy = ((e1 == e2).all(-1) & (e1 != 0).any(-1)).numpy()
    zero_edge = ((e1 == 0).all(-1) | (e2 == 0).all(-1)).numpy()
    assert zero_edge[~noisy].any() and (~noisy).sum() >= 56
    for g, w in zip(got, want):
        _close(g.numpy()[~noisy], np.asarray(w)[~noisy], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("center", [True, False])
def test_pca_matches_mpa_tpu(center):
    x = _x(9, (50, 6)) * np.array([5, 3, 2, 1, 0.5, 0.1], np.float32)
    want = jgeo.pca(jnp.asarray(x), 3, center=center)
    got = geometry.pca(_t(x), 3, center=center)
    assert got["k"] == 3 and got["X"] is not None and tuple(got["components"].shape) == (6, 3)
    _close(got["explained_variance"], want["explained_variance"], atol=0, rtol=1e-5)
    g, w = got["components"].numpy(), np.asarray(want["components"])
    signs = np.sign(np.sum(g * w, axis=0))  # each column up to its sign
    assert (np.abs(signs) == 1).all()
    np.testing.assert_allclose(g * signs, w, atol=1e-5)


# -- the plain set abstraction ---------------------------------------------------------


@pytest.mark.parametrize("group_all,feat,polar,normal,train", [
    (False, 0, True, True, False),  # normals only
    (False, 12, True, True, False),
    (False, 12, False, False, False),  # no polar channels, no normals among the features
    (False, 12, True, True, True),
    (True, 12, True, True, False),  # the whole cloud
    (True, 12, False, False, True),
])
def test_surface_abstraction_matches_mpa_tpu(group_all, feat, polar, normal, train):
    center, nrm, feature = _sa_inputs(21, feat=feat)
    kw = dict(npoint=0 if group_all else 32, radius=0.0 if group_all else 0.2,
              nsample=0 if group_all else 24, group_all=group_all, return_polar=polar,
              return_normal=normal)
    jm = JaxSA(mlp=(16, 24), **kw)
    jargs = (jnp.asarray(center), jnp.asarray(nrm),
             None if feature is None else jnp.asarray(feature))
    flat = jax_variables(jm, *jargs)
    grouped_normal = feature is None or normal
    tm, unused = port(SurfaceAbstraction(in_channel=(10 if grouped_normal else 0) + feat,
                                         mlp=(16, 24), **kw), flat)
    assert unused == []
    targs = (_t(center), _t(nrm), None if feature is None else _t(feature))
    if train:
        (wc, wn, wf), _ = jm.apply(_nest(flat), *jargs, train=True, mutable=["batch_stats"])
        tm.train()
    else:
        wc, wn, wf = jm.apply(_nest(flat), *jargs, train=False)
    with torch.no_grad():
        gc, gn, gf = tm(*targs)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert tuple(gf.shape) == (2, 1 if group_all else 32, 24)
    _close(gf, wf, atol=1e-4 if train else 1e-5, rtol=1e-5)


# -- the ops nothing calls -------------------------------------------------------------


def test_mod_index_matches_mpa_tpu():
    base, vals = _x(10, (2, 9, 4)), _x(11, (2, 3, 4))
    idx = np.array([[0, 4, 8], [2, 1, 7]], np.int32)  # no repeated index (module doc)
    want = np.asarray(jops.mod_index(jnp.asarray(base), jnp.asarray(idx), jnp.asarray(vals)))
    got = ops.mod_index(_t(base), _t(idx), _t(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1, [2, 1, 7]].numpy(), vals[1])
    np.testing.assert_array_equal(got[0, [1, 2, 3, 5, 6, 7]].numpy(), base[0, [1, 2, 3, 5, 6, 7]])
    with pytest.raises(ValueError, match="mod_index"):
        ops.mod_index(_t(base), _t(idx[:, :2]), _t(vals))


def test_knn_self_matches_mpa_tpu():
    x = _x(12, (2, 40, 3))
    x[:, 5] = x[:, 4]  # a duplicate: a tie at 0, to the lower index
    wd, wi = jops.knn_self(6, jnp.asarray(x))
    gd, gi = ops.knn_self(6, _t(x))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    _close(gd, wd, atol=1e-6)
    own = np.arange(40)
    own[5] = 4  # the duplicate's own match ties its twin's, at the lower index
    assert (gi[..., 0].numpy() == own).all() and not gd[..., 0].any()


def test_knn_point2_contract():
    """Its own match first at 0; a coincident duplicate pushed past the
    neighbours (10 + noise); the distances ascending and, away from zero,
    the plain squared distances; the noise drawn from the generator."""
    x = _x(13, (2, 16, 3))
    x[:, 1] = x[:, 0]
    d, idx = ops.knn_point2(4, _t(x), torch.Generator().manual_seed(0))
    assert idx.dtype == torch.int32 and tuple(idx.shape) == tuple(d.shape) == (2, 16, 4)
    assert (idx[..., 0].numpy() == np.arange(16)).all() and not d[..., 0].any()
    assert (idx[:, 0, 1] != 1).all() and (idx[:, 1, 1] != 0).all()
    assert (np.diff(d.numpy(), axis=-1) >= 0).all()
    sd = ops.square_distance(_t(x), _t(x))
    picked = torch.gather(sd, 2, idx.long())
    near = picked != 0
    np.testing.assert_array_equal(d.numpy()[near.numpy()], picked.numpy()[near.numpy()])
    # mpa_tpu's own contract, the same way (its test_knn_point2_detie_duplicates)
    _, jidx = jops.knn_point2(4, jnp.asarray(x), jax.random.key(0))
    assert np.asarray(jidx)[0, 0, 0] == 0 and np.asarray(jidx)[0, 0, 1] != 1
    again = ops.knn_point2(4, _t(x), torch.Generator().manual_seed(0))
    assert torch.equal(again[0], d) and torch.equal(again[1], idx)


@pytest.mark.parametrize("index_shape", [None, (2, 12), (2, 6, 4)])
def test_inner_correlation_matches_mpa_tpu(index_shape):
    z = _x(14, (2, 20, 8))
    z[0, 3] = 0.0  # a zero row: its cosines 0, not NaN
    index = None
    if index_shape is not None:
        index = np.random.default_rng(15).integers(0, 20, index_shape).astype(np.int32)
        index[0, 0] = 3
    want = jops.inner_correlation(jnp.asarray(z), None if index is None else jnp.asarray(index))
    got = ops.inner_correlation(_t(z), None if index is None else _t(index))
    assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
    assert torch.isfinite(got).all()
    _close(got, want, atol=1e-6)


def test_random_sample_contract():
    pts = _x(16, (3, 20, 4))
    out = ops.random_sample(torch.Generator().manual_seed(0), _t(pts), 8)
    assert tuple(out.shape) == (3, 8, 4)
    for b in range(3):  # each cloud's rows, none repeated, drawn on their own
        rows = [int(np.flatnonzero((pts[b] == r).all(-1))[0]) for r in out[b].numpy()]
        assert len(set(rows)) == 8
    again = ops.random_sample(torch.Generator().manual_seed(0), _t(pts), 8)
    assert torch.equal(out, again)


def test_shared_random_sample_contract():
    pts = _x(17, (3, 20, 3))
    sampled, idx = ops.shared_random_sample(torch.Generator().manual_seed(1), _t(pts), 8)
    assert tuple(sampled.shape) == (3, 8, 3) and idx.dtype == torch.int32
    assert tuple(idx.shape) == (3, 8) and (idx == idx[0]).all()  # one permutation for the batch
    assert len(set(idx[0].tolist())) == 8 and int(idx.max()) < 20
    np.testing.assert_array_equal(sampled[1].numpy(), pts[1][idx[1].numpy()])
    with pytest.raises(ValueError, match="without replacement"):
        ops.shared_random_sample(torch.Generator(), _t(pts), 21)


# -- the profile breakdowns ------------------------------------------------------------


def test_kernel_category_names_the_ports_kernels_first():
    assert kernel_category("void knn_kernel_stream<4, true>(Args)") == "knn_kernel"
    assert kernel_category("windowed_knn_kernel_resident") == "windowed_knn_kernel"
    assert kernel_category("windowed_scatter_mean_kernel<256>") == "windowed_scatter_mean_kernel"
    assert kernel_category("fps_slice_kernel<16>") == "fps_kernel"
    assert kernel_category("sm90_xmma_gemm_f32f32_tf32f32") == MATMUL
    assert kernel_category("ampere_sgemm_128x64_nn") == MATMUL
    assert kernel_category("vectorized_elementwise_kernel") == OTHER


def _event(name, start, end, device=torch.autograd.DeviceType.CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_op_and_category_breakdowns_of_a_profile():
    """A profile's device events by name and by category, in ms, largest
    first; host events and region annotations are left out."""
    events = [_event("knn_kernel_stream", 0, 1000), _event("knn_kernel_stream", 2000, 2500),
              _event("ampere_sgemm_64x64", 3000, 5000), _event("elementwise_kernel", 5000, 5100),
              _event("gather_rows_kernel<4>", 6000, 6200),
              _event("Optimizer.step", 0, 9000, annotation=True),
              _event("aten::mm", 0, 9000, device=torch.autograd.DeviceType.CPU)]
    prof = SimpleNamespace(events=lambda: events)
    total, rows = op_breakdown(prof)
    assert total == pytest.approx(3.8)
    assert [(r["name"], r["count"]) for r in rows] == [
        ("ampere_sgemm_64x64", 1), ("knn_kernel_stream", 2), ("gather_rows_kernel<4>", 1),
        ("elementwise_kernel", 1)]
    assert rows[1]["ms"] == pytest.approx(1.5) and rows[1]["category"] == "knn_kernel"
    assert rows[1]["source"] == kernels.SOURCES["knn_kernel"] and rows[0]["source"] == ""
    total2, cats = category_breakdown(prof)
    assert total2 == total
    assert [(c["category"], c["count"]) for c in cats] == [
        (MATMUL, 1), ("knn_kernel", 2), ("gather_rows_kernel", 1), (OTHER, 1)]
    assert sum(c["ms"] for c in cats) == pytest.approx(total)
