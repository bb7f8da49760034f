"""Port parity, ``repsurf_ssg_2x`` inference, on the CPU: the umbrella
geometry, ``resort_points``, the ball query, the umbrella surface
constructor, the set abstraction and the whole classifier, each against its
``mpa_tpu`` twin on the same numpy inputs made from a seed, and the geometry
and the umbrella constructor against the frozen torch-oracle fixtures.

``mpa_tpu`` runs as its own tests run it: JAX on the CPU, where its ball
query takes the XLA formulation, and its Pallas ball-query kernel in
interpret mode. The port takes its plain ops, because the tensors lie on the
CPU; ``ball_query_kernel`` is held against ``ball_query_plain`` on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

Tolerances. Geometry: 1e-6 absolute (the same float32 arithmetic, a sum of
three terms perhaps in another order) and the fixtures' own bounds.
Indices: equal, except where XLA's einsum and the port's channel-order sum
part on a distance within a last bit of the radius; there the picks are held
to the Pallas tests' ``check_ball_semantics`` rule. Modules and the model:
1e-5 for single modules, 1e-4 for the whole classifier's log-probs (float32
matmuls in another order through four stages).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle_cache import oracle  # noqa: E402
from test_torch_port_cls import _nest, jax_variables, port, state_to_flax  # noqa: E402

from mpa_tpu import geometry as jgeo  # noqa: E402
from mpa_tpu.models.repsurf_ssg_2x import RepSurfSSG2x as JaxRepSurf  # noqa: E402
from mpa_tpu.nn.surface_abstraction import SurfaceAbstractionCD as JaxSA  # noqa: E402
from mpa_tpu.nn.umbrella_constructor import UmbrellaSurfaceConstructor as JaxUmbrella  # noqa: E402
from mpa_tpu.ops.ball_query import ball_query as jax_ball_query  # noqa: E402
from mpa_tpu.ops.gather import resort_points as jax_resort_points  # noqa: E402
from mpa_tpu.ops.pairwise import square_distance as jax_square_distance  # noqa: E402
from mpa_tpu.ops.pallas.ball_pallas import ball_query_indices_pallas  # noqa: E402
from mpa_tpu_torch import geometry  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.models import RepSurfSSG2x  # noqa: E402
from mpa_tpu_torch.nn import SurfaceAbstractionCD, UmbrellaSurfaceConstructor  # noqa: E402
from mpa_tpu_torch.ops import ball_query, resort_points, square_distance  # noqa: E402
from mpa_tpu_torch.ops.ball_query import ball_query_cuda, ball_query_plain  # noqa: E402
from mpa_tpu_torch.serve import load_classifier  # noqa: E402

SMALL = dict(width_div=8, sa_npoints=(64, 32, 8))  # 128-point clouds


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _triangles(seed, shape):
    """Random triangles with degenerate ones planted: a vertex repeating the
    first gives a zero edge, so an exactly zero cross product on both sides
    (the umbrella's case of a neighbour on its centre). Two equal edges are
    another matter: ``test_equal_edges_give_a_zero_normal``."""
    tri = _x(seed, shape)
    tri[0, 1, 0, 1] = tri[0, 1, 0, 0]  # fan (0, 1): triangle 0 degenerate
    tri[1, 2, 2, 2] = tri[1, 2, 2, 0]
    tri[1, 3, :, 2] = tri[1, 3, :, 0]  # fan (1, 3): every triangle degenerate
    return tri


# -- geometry ----------------------------------------------------------------------


def test_xyz2sphere_matches_mpa_tpu_and_fixture():
    f = oracle("geometry", lambda: pytest.fail("fixture geometry.npz missing"))
    _close(geometry.xyz2sphere(_t(f["sphere/x"])), f["sphere/want"], atol=1e-5)
    x = _x(0, (2, 40, 3))
    x[0, :4] = 0.0  # the origin
    x[1, :4, :2] = 0.0  # the z axis
    _close(geometry.xyz2sphere(_t(x)), jgeo.xyz2sphere(jnp.asarray(x)), atol=1e-6)
    _close(geometry.xyz2sphere(_t(x), normalize=False),
           jgeo.xyz2sphere(jnp.asarray(x), normalize=False), atol=1e-6)


def test_xyz2sphere_gradient_is_finite_at_the_guards():
    """The double-where guards: the origin, the z axis and the poles give
    finite gradients, equal to ``jax.grad``'s."""
    x = _x(1, (3, 8, 3))
    x[0, :3] = 0.0
    x[1, :3, :2] = 0.0
    w = _x(2, (3, 8, 3))
    want = jax.grad(lambda p: jnp.sum(jgeo.xyz2sphere(p) * w))(jnp.asarray(x))
    t = _t(x).requires_grad_(True)
    (geometry.xyz2sphere(t) * _t(w)).sum().backward()
    assert torch.isfinite(t.grad).all()
    _close(t.grad, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("is_group", [True, False])
def test_cal_normal_matches_mpa_tpu_and_fixture(is_group):
    f = oracle("geometry", lambda: pytest.fail("fixture geometry.npz missing"))
    key = "normal_group" if is_group else "normal_nongroup"
    _close(geometry.cal_normal(_t(f[f"{key}/tri"]), is_group=is_group), f[f"{key}/want"],
           atol=1e-5)
    tri = _triangles(3, (2, 6, 5, 3, 3) if is_group else (2, 6, 3, 3))
    got = geometry.cal_normal(_t(tri), is_group=is_group)
    _close(got, jgeo.cal_normal(jnp.asarray(tri), is_group=is_group), atol=1e-6)
    if is_group:
        assert (got[0, 1, 0] == 0).all() and (got[1, 2, 2] == 0).all()  # zero, not NaN
        assert (got[1, 3] == 0).all()


def test_equal_edges_give_a_zero_normal():
    """A triangle whose two other vertices coincide (two neighbours of a
    centre repeat one point) has equal edges: the port's cross product is
    exactly zero, so its normal is zero and the fan repairs it, as the
    reference's NaN is repaired. XLA on the CPU contracts ``jnp.cross`` into
    fused multiply-adds, and ``a1 * a2 - a2 * a1`` then leaves a rounding
    residue: ``mpa_tpu`` gets a unit normal of noise there instead."""
    tri = _x(16, (1, 4, 3, 3, 3))
    tri[0, :, 1, 2] = tri[0, :, 1, 1]
    got = geometry.cal_normal(_t(tri), is_group=True)
    assert (got[0, :, 1] == 0).all()
    assert (got[0, :, 0] != 0).any(-1).all() and (got[0, :, 2] != 0).any(-1).all()
    jax_noise = np.asarray(jgeo.cal_normal(jnp.asarray(tri), is_group=True))[0, :, 1]
    np.testing.assert_allclose(np.linalg.norm(jax_noise, axis=-1), 1.0, atol=1e-5)
    repaired, _ = geometry.check_nan_umbrella(got, _t(tri).mean(-2))
    assert torch.equal(repaired[0, :, 1], repaired[0, :, 0])


def test_cal_normal_flips_match_the_jax_key():
    """The train-time inversion: the port takes the signs that
    ``jax.random.randint(key, (B,), 0, 2) * 2 - 1`` draws."""
    tri = _triangles(4, (4, 6, 5, 3, 3))
    key = jax.random.key(7)
    flips = np.asarray(jax.random.randint(key, (4,), 0, 2)).astype(np.float32) * 2.0 - 1.0
    assert (flips == 1).any() and (flips == -1).any()
    want = jgeo.cal_normal(jnp.asarray(tri), random_inv_key=key, is_group=True)
    _close(geometry.cal_normal(_t(tri), flips=_t(flips), is_group=True), want, atol=1e-6)
    drawn = geometry.random_flips(64, torch.Generator().manual_seed(0), torch.device("cpu"))
    assert set(drawn.tolist()) == {-1.0, 1.0}


def test_cal_center_and_cal_const_match_mpa_tpu_and_fixture():
    f = oracle("geometry", lambda: pytest.fail("fixture geometry.npz missing"))
    _close(geometry.cal_center(_t(f["center/tri"])), f["center/want"], atol=1e-6)
    _close(geometry.cal_const(_t(f["const/n"]), _t(f["const/c"])), f["const/want"], atol=1e-6)
    tri = _triangles(5, (2, 6, 5, 3, 3))
    n = geometry.cal_normal(_t(tri), is_group=True)
    c = geometry.cal_center(_t(tri))
    _close(c, jgeo.cal_center(jnp.asarray(tri)), atol=1e-6)
    jn = jgeo.cal_normal(jnp.asarray(tri), is_group=True)
    _close(geometry.cal_const(n, c), jgeo.cal_const(jn, jgeo.cal_center(jnp.asarray(tri))),
           atol=1e-6)
    _close(geometry.cal_const(n, c, is_normalize=False),
           jgeo.cal_const(jn, jgeo.cal_center(jnp.asarray(tri)), is_normalize=False), atol=1e-6)


def test_check_nan_umbrella_matches_mpa_tpu_and_fixture():
    f = oracle("geometry", lambda: pytest.fail("fixture geometry.npz missing"))
    got = geometry.check_nan_umbrella(_t(f["nan_umb/normal"]), _t(f["nan_umb/center"]),
                                      _t(f["nan_umb/pos"]))
    for g, k in zip(got, ("normal", "center", "pos")):
        _close(g, f[f"nan_umb/want_{k}"], atol=1e-6)
    tri = _triangles(6, (2, 6, 5, 3, 3))
    normal = _t(tri).sum(-2)
    normal[0, 1, 0] = float("nan")  # a NaN row, the reference's marker
    normal[0, 2, 1:3] = 0.0  # zero rows: the port's marker
    normal[1, 3] = 0.0  # a fan with no valid row: row 0 stays
    center, pos = _t(_x(7, (2, 6, 5, 3))), _t(_x(8, (2, 6, 5, 1)))
    want = jgeo.check_nan_umbrella(*(jnp.asarray(a.numpy()) for a in (normal, center, pos)))
    got = geometry.check_nan_umbrella(normal, center, pos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got2 = geometry.check_nan_umbrella(normal, center)
    assert len(got2) == 2 and torch.equal(got2[1], got[1])


def test_group_by_umbrella_matches_mpa_tpu_and_fixture():
    f = oracle("geometry", lambda: pytest.fail("fixture geometry.npz missing"))
    x = _t(f["umbrella/x"])
    _close(geometry.group_by_umbrella(x, x, k=7), f["umbrella/want"], atol=1e-5)
    # Repeated points: ties in the kNN and equal azimuths in the stable sort.
    x = _x(9, (2, 64, 3))
    x[:, 1::4] = x[:, 0::4]
    want = jgeo.group_by_umbrella(jnp.asarray(x), jnp.asarray(x), k=9)
    got = geometry.group_by_umbrella(_t(x), _t(x), k=9)
    assert tuple(got.shape) == (2, 64, 8, 3, 3)
    _close(got, want, atol=1e-6)


def test_resort_points_matches_mpa_tpu():
    pts = _x(10, (2, 12, 8, 5))
    idx = np.stack([np.random.default_rng(11 + i).permutation(8) for i in range(2 * 12)])
    idx = idx.reshape(2, 12, 8).astype(np.int32)
    want = jax_resort_points(jnp.asarray(pts), jnp.asarray(idx))
    np.testing.assert_array_equal(resort_points(_t(pts), _t(idx)).numpy(), np.asarray(want))


# -- the ball query ------------------------------------------------------------------


def check_ball_semantics(got, d, radius, N, ns, tol=1e-4):
    """``tests/test_pallas_kernels.py``'s rule for a sentinel stage that may
    part from another at the radius: picks ascending and unique with the
    sentinels at the tail, inside the radius within ``tol``, and no index
    robustly inside it missing below the selection horizon."""
    r2 = radius * radius
    for b in range(got.shape[0]):
        for s in range(got.shape[1]):
            row = got[b, s]
            picks = row[row < N]
            assert np.all(row[len(picks):] == N), (b, s, row)
            assert np.all(np.diff(picks) > 0), (b, s, picks)
            assert np.all(d[b, s, picks] <= r2 + tol), (b, s)
            inside = np.where(d[b, s] < r2 - tol)[0]
            if len(picks) == ns:
                inside = inside[inside < picks[-1]]
            assert np.setdiff1d(inside, picks).size == 0, (b, s)


BALL_CASES = [
    (100, 33, 8, 0.6),  # ragged N and S
    (128, 128, 24, 0.3),  # the model's nsample
    (257, 40, 4, 0.2),  # sparse balls: many sentinels
    (64, 16, 64, 3.0),  # everything in radius, nsample == N
]


@pytest.mark.parametrize("N,S,ns,radius", BALL_CASES)
def test_ball_query_plain_matches_mpa_tpu_and_the_pallas_kernel(N, S, ns, radius):
    xyz = _x(7, (2, N, 3))
    q = xyz[:, :S]
    got = ball_query_plain(radius, ns, _t(xyz), _t(q)).numpy()
    assert got.dtype == np.int32 and got.shape == (2, S, ns)
    d = np.asarray(jax_square_distance(jnp.asarray(q), jnp.asarray(xyz)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(ball_query_indices_pallas(radius, ns, jnp.asarray(xyz), jnp.asarray(q)))
    if not np.array_equal(got, pallas):
        check_ball_semantics(got, d, radius, N, ns)
        check_ball_semantics(pallas, d, radius, N, ns)
    # The backfilled groups against mpa_tpu's ball_query (its XLA path here).
    want = np.asarray(jax_ball_query(radius, ns, jnp.asarray(xyz), jnp.asarray(q)))
    full = ball_query(radius, ns, _t(xyz), _t(q)).numpy()
    if np.array_equal(got, pallas):
        np.testing.assert_array_equal(full, want)
    else:
        assert ((full >= 0) & (full < N)).all()


def test_ball_query_identical_points_and_backfill():
    xyz = np.ones((2, 256, 3), np.float32)
    want = np.asarray(jax_ball_query(0.5, 16, jnp.asarray(xyz), jnp.asarray(xyz[:, :64])))
    got = ball_query(0.5, 16, _t(xyz), _t(xyz[:, :64])).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.broadcast_to(np.arange(16, dtype=np.int32), got.shape))
    # A centre far from every point: all slots 0; a centre with one hit: all
    # slots that hit.
    xyz = _x(8, (1, 50, 3))
    q = np.stack([np.full(3, 100.0, np.float32), xyz[0, 17]])[None]
    got = ball_query(1e-3, 8, _t(xyz), _t(q)).numpy()
    want = np.asarray(jax_ball_query(1e-3, 8, jnp.asarray(xyz), jnp.asarray(q)))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0] == 0).all() and (got[0, 1] == 17).all()


def test_ball_query_boundary_uses_the_float32_square_of_the_radius():
    """A radius whose square, rounded once to float32, equals a distance
    exactly keeps that point in the ball, on the port's and JAX's side."""
    xyz = _x(9, (1, 64, 3))
    q = xyz[:, :4]
    d = square_distance(_t(q), _t(xyz)).numpy()
    radius = float(np.sqrt(np.float64(d[0, 0, 40])))
    got = ball_query_plain(radius, 64, _t(xyz), _t(q)).numpy()
    assert 40 in got[0, 0]
    assert 40 in np.asarray(jax_ball_query(radius, 64, jnp.asarray(xyz), jnp.asarray(q)))[0, 0]


def test_ball_query_cpu_launches_no_kernel_and_the_cuda_wrapper_refuses_cpu():
    xyz = _t(_x(10, (1, 40, 3)))
    kernels.reset_launch_counts()
    ball_query(0.5, 8, xyz, xyz[:, :5])
    assert kernels.LAUNCHES["ball_query_kernel"] == 0
    with pytest.raises(ValueError):
        ball_query_cuda(0.5, 8, xyz, xyz[:, :5].contiguous())
    with pytest.raises(ValueError):
        ball_query(0.5, 41, xyz, xyz)  # nsample > N


# -- modules -------------------------------------------------------------------------


@pytest.mark.parametrize("aggr", ["sum", "max", "avg"])
def test_umbrella_constructor_matches_mpa_tpu(aggr):
    """Repeated points give degenerate triangles. Those with a zero edge are
    repaired on both sides; the points whose fans hold a triangle with two
    equal edges are left out of the comparison, where ``mpa_tpu`` keeps a
    normal of rounding noise (``test_equal_edges_give_a_zero_normal``)."""
    x = _x(11, (2, 48, 3))
    x[:, [1, 20, 33]] = x[:, [0, 19, 32]]  # repeated points: degenerate triangles
    jm = JaxUmbrella(k=9, aggr_type=aggr)
    flat = jax_variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(_nest(flat), jnp.asarray(x), train=False))
    tm, unused = port(UmbrellaSurfaceConstructor(aggr_type=aggr), flat)
    assert unused == []
    with torch.no_grad():
        got = tm(_t(x)).numpy()
        fans = geometry.group_by_umbrella(_t(x), _t(x), k=9)
    e1, e2 = fans[..., 1, :], fans[..., 2, :]
    noisy = ((e1 == e2).all(-1) & (e1 != 0).any(-1)).any(-1).numpy()  # [B, N]
    zero_edge = ((e1 == 0).all(-1) | (e2 == 0).all(-1)).any(-1).numpy()
    assert noisy.any() and zero_edge[~noisy].any() and (~noisy).sum() > 48
    _close(got[~noisy], want[~noisy], atol=1e-5, rtol=1e-5)


def test_umbrella_constructor_matches_frozen_torch_oracle():
    f = oracle("nn_umbrella_sum", lambda: pytest.fail("fixture nn_umbrella_sum.npz missing"))
    variables = {k: v for k, v in f.items() if k.startswith("variables/")}
    tm, unused = port(UmbrellaSurfaceConstructor(aggr_type="sum"), variables)
    assert unused == []
    x = _t(f["x"])
    with torch.no_grad():
        _close(tm(x, flips=torch.ones(x.shape[0])), f["want"], atol=2e-4)


def test_umbrella_constructor_train_mode_with_the_jax_flips():
    """Train mode: the same flips as the JAX key's, batch statistics and the
    updated running statistics."""
    x = _x(12, (4, 40, 3))
    jm = JaxUmbrella(k=9)
    flat = jax_variables(jm, jnp.asarray(x))
    key = jax.random.key(3)
    flips = np.asarray(jax.random.randint(key, (4,), 0, 2)).astype(np.float32) * 2.0 - 1.0
    want, upd = jm.apply(_nest(flat), jnp.asarray(x), train=True, rng=key, mutable=["batch_stats"])
    tm, _ = port(UmbrellaSurfaceConstructor(), flat)
    tm.train()
    with pytest.raises(ValueError, match="flips or a torch.Generator"):
        tm(_t(x))
    got = tm(_t(x), flips=_t(flips))
    _close(got, want, atol=1e-5, rtol=1e-5)
    for bn in ("bn0", "bn1"):
        stats = upd["batch_stats"][bn]
        _close(getattr(tm, bn).running_mean, stats["mean"], atol=1e-6, rtol=1e-5)
        _close(getattr(tm, bn).running_var, stats["var"], atol=1e-6, rtol=1e-5)


def _sa_inputs(seed, B=2, N=96, feat=12):
    center = _x(seed, (B, N, 3), scale=0.15)  # about 11 points a ball at radius 0.2
    center[:, 5::5] = center[:, 4::5][:, :center[:, 5::5].shape[1]]  # repeated points
    normal = _x(seed + 1, (B, N, 10))
    feature = None if feat == 0 else _x(seed + 2, (B, N, feat))
    return center, normal, feature


@pytest.mark.parametrize("group_all,feat,train", [
    (False, 0, False),  # sa1: normals only
    (False, 12, False),
    (False, 12, True),
    (True, 12, False),  # sa4: the whole cloud
    (True, 12, True),
])
def test_surface_abstraction_matches_mpa_tpu(group_all, feat, train):
    center, normal, feature = _sa_inputs(13, feat=feat)
    kw = dict(npoint=0 if group_all else 32, radius=0.0 if group_all else 0.2,
              nsample=0 if group_all else 24, group_all=group_all)
    jm = JaxSA(pos_channel=6, mlp=(16, 16, 24), return_polar=True, **kw)
    jargs = (jnp.asarray(center), jnp.asarray(normal),
             None if feature is None else jnp.asarray(feature))
    flat = jax_variables(jm, *jargs)
    tm, unused = port(SurfaceAbstractionCD(in_channel=10 + feat, mlp=(16, 16, 24), **kw), flat)
    assert unused == []
    targs = (_t(center), _t(normal), None if feature is None else _t(feature))
    if train:
        (wc, wn, wf), upd = jm.apply(_nest(flat), *jargs, train=True, mutable=["batch_stats"])
        tm.train()
        gc, gn, gf = tm(*targs)
    else:
        wc, wn, wf = jm.apply(_nest(flat), *jargs, train=False)
        with torch.no_grad():
            gc, gn, gf = tm(*targs)
    np.testing.assert_array_equal(gc.detach().numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gn.detach().numpy(), np.asarray(wn))
    assert tuple(gf.shape) == (2, 1 if group_all else 32, 24)
    # Train mode normalises by batch statistics summed in another order over
    # groups that repeat rows (backfilled balls): 1e-4 (read: 1.4e-5).
    _close(gf, wf, atol=1e-4 if train else 1e-5, rtol=1e-5)
    if train:
        got = state_to_flax({k: v for k, v in tm.state_dict().items() if "running" in k})
        for key, v in got.items():
            *path, leaf = key.split("/")[1:]
            node = upd["batch_stats"]
            for p in path:
                node = node[p]
            _close(v, node[leaf], atol=1e-5, rtol=1e-5)


# -- the classifier --------------------------------------------------------------------


def test_repsurf_matches_mpa_tpu():
    """Eval log-probs at a small size (``width_div=8``, ladder 64/32/8, 128
    points at 0.2x scale so balls hold real neighbours), atol 1e-4; the
    converter maps every variable and leaves none over."""
    x = _x(14, (2, 128, 3), scale=0.2)
    jm = JaxRepSurf(num_classes=15, **SMALL)
    flat = jax_variables(jm, jnp.asarray(x))
    jfwd = jax.jit(lambda v, p: jm.apply(v, p, train=False))
    want = np.asarray(jfwd(_nest(flat), jnp.asarray(x)))
    tm, unused = port(RepSurfSSG2x(num_classes=15, **SMALL), flat)
    assert unused == [] and set(state_to_flax(tm.state_dict())) == set(flat)
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    assert got.shape == (2, 15) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_repsurf_widths_follow_the_published_config():
    m = RepSurfSSG2x()
    assert (m.sa1.npoint, m.sa2.npoint, m.sa3.npoint) == (512, 128, 32)
    assert (m.sa1.radius, m.sa2.radius, m.sa3.radius) == (0.1, 0.2, 0.4)
    assert m.sa1.nsample == m.sa2.nsample == m.sa3.nsample == 24 and m.sa4.group_all
    assert m.sa1.mlp_f0.in_features == 10 and m.sa2.mlp_f0.in_features == 10 + 256
    assert m.sa4.mlps.conv1.out_features == 2048 and m.fc1.in_features == 2048
    assert (m.fc1.out_features, m.fc2.out_features, m.fc3.out_features) == (512, 256, 15)
    assert m.surface_constructor.mlp0.bias is None and m.dropout == 0.4


def test_load_classifier_scanobjectnn_2x_on_cpu():
    """``load_classifier("scanobjectnn_2x", device="cpu")`` at full width,
    B = 2 x 1024: finite log-probs, and the same output from its weights
    carried as flax variables."""
    clf = load_classifier("scanobjectnn_2x", device="cpu", seed=1)
    assert isinstance(clf.model, RepSurfSSG2x)
    x = _x(15, (2, 1024, 3), scale=0.3)
    kernels.reset_launch_counts()
    a = clf(x)
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
    assert a.shape == (2, 15) and torch.isfinite(a).all()
    torch.testing.assert_close(torch.exp(a).sum(-1), torch.ones(2))
    clf2 = load_classifier("scanobjectnn_2x", variables=state_to_flax(clf.model.state_dict()),
                           device="cpu")
    torch.testing.assert_close(clf2(x), a, rtol=0, atol=0)


def test_surface_clouds_hold_neighbours_in_the_first_balls():
    """``surface_clouds``: shapes, labels, centred clouds of unit radius, the
    same clouds from the same seed, and sa1's balls (512 FPS centres of 1024
    points, radius 0.1, 24 slots) holding neighbours, where the volume
    clouds of ``synthetic_clouds`` mostly hold their centre alone (read: 8.6
    and 1.9 points a ball on 16 clouds)."""
    from mpa_tpu_torch.data import surface_clouds, synthetic_clouds
    from mpa_tpu_torch.ops import farthest_point_sample, index_points

    pts, labels = surface_clouds(16, 1024, seed=0)
    assert pts.shape == (16, 1024, 3) and pts.dtype == np.float32 and labels.dtype == np.int64
    assert ((labels >= 0) & (labels < 15)).all() and len(set(labels.tolist())) > 5
    np.testing.assert_allclose(pts.mean(1), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=-1).max(1), 1.0, atol=1e-6)
    again, _ = surface_clouds(16, 1024, seed=0)
    assert np.array_equal(pts, again) and not np.array_equal(pts, surface_clouds(16, 1024, seed=1)[0])

    def hits(clouds):
        x = _t(clouds)
        centres = index_points(x, farthest_point_sample(x, 512).long())
        return float((ball_query_plain(0.1, 24, x, centres) < 1024).sum(-1).float().mean())

    assert hits(pts) > 6.0 and hits(synthetic_clouds(16, 1024, seed=0)[0]) < 3.0
