"""Port parity, the Morton-window ops, on the CPU.

Each piece of ``mpa_tpu_torch``'s window modes against its ``mpa_tpu`` twin
on the same numpy inputs: the Morton codes and order, ``make_window_spec``,
banded FPS, the windowed kNN, the windowed transition attention and the
windowed scatter-mean, forward and gradients; and ``markov_partseg`` in the
window modes. ``mpa_tpu``'s Pallas kernels
run as ``tests/test_window_attention.py`` runs them on the CPU, in interpret
mode; the port takes its plain versions, because the tensors lie on the CPU.
The CUDA kernels are held against the plain versions on the card
(``tests/test_torch_port_cuda.py``).

Tolerances. Morton codes, orders, specs, FPS and kNN indices: exact. kNN
distances: 1e-6 relative and absolute, since ``mpa_tpu`` sums the squares of
a difference in XLA's order and the port in channel order. The attention
forward: 1e-6 (the same arithmetic, the denominator summed in another order
by XLA). Gradients against the Pallas kernels with ``hilo`` scatter
precision (exact f32 sums): 1e-5 of the largest entry, for the order of the
adds. The scatter-mean: 1e-6 (a sum of at most S*K terms and one divide).
The part segmenter: 1e-4, the bound of its exact-mode test.
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
from test_torch_port_cls import _nest, jax_variables, port  # noqa: E402  (pins torch's threads)

from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu.ops import morton as jmorton  # noqa: E402
from mpa_tpu.ops import banded_farthest_point_sample as jax_banded_fps  # noqa: E402
from mpa_tpu.ops import pick_fps_bands as jax_pick_fps_bands  # noqa: E402
from mpa_tpu.ops.pallas import attention_pallas as JAP  # noqa: E402
from mpa_tpu.ops.pallas import window_attention as JWA  # noqa: E402
from mpa_tpu_torch.models import MarkovPartSeg  # noqa: E402
from mpa_tpu_torch.ops import window as W  # noqa: E402
from mpa_tpu_torch.ops.fps import banded_farthest_point_sample, pick_fps_bands  # noqa: E402
from mpa_tpu_torch.ops.morton import morton_code, morton_order, morton_sort  # noqa: E402


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _sorted_pair(seed, B, S, N, C=3, dup=False):
    """Morton-ordered base [B,N,C] and query [B,S,C]: stride subsamples of
    one sorted cloud for C = 3 (how the model's scales relate after sorted
    FPS), features in the same row order otherwise; ``dup`` repeats points."""
    M = max(S, N)
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, M, 3)).astype(np.float32)
    if dup:
        xyz[:, 1::4] = xyz[:, 0::4][:, : xyz[:, 1::4].shape[1]]
    cloud = morton_sort(torch.from_numpy(xyz))[0].numpy()
    if C != 3:
        cloud = (np.cumsum(rng.standard_normal((B, M, C)), 1) / 8).astype(np.float32)
    return (np.ascontiguousarray(cloud[:, :: M // N]), np.ascontiguousarray(cloud[:, :: M // S]))


# -- Morton order ----------------------------------------------------------------------


@pytest.mark.parametrize("scale,dup", [(1.0, False), (1e-3, True), (250.0, True)])
def test_morton_code_and_order_match_mpa_tpu(scale, dup):
    """Bit-equal codes and the same stable order, repeated points included
    (S3DIS blocks are drawn with replacement: ties go to the input order)."""
    rng = np.random.default_rng(int(scale * 1000) % 97)
    x = (scale * rng.standard_normal((3, 2048, 3)) + 5.0).astype(np.float32)
    if dup:
        x[:, 1::3] = x[:, 0::3][:, : x[:, 1::3].shape[1]]
        x[:, 7] = x[:, 500]
    want_code = np.asarray(jmorton.morton_code(jnp.asarray(x)))
    got_code = morton_code(torch.from_numpy(x)).numpy()
    assert got_code.dtype == np.int32
    np.testing.assert_array_equal(got_code, want_code)
    assert (len(np.unique(got_code[0])) < 2048) == dup  # repeated points: ties to break
    np.testing.assert_array_equal(morton_order(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmorton.morton_order(jnp.asarray(x))))
    feat = rng.standard_normal((3, 2048, 5)).astype(np.float32)
    want = jmorton.morton_sort(jnp.asarray(x), jnp.asarray(feat))
    got = morton_sort(torch.from_numpy(x), torch.from_numpy(feat))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_morton_code_of_a_flat_cloud():
    x = np.zeros((1, 16, 3), np.float32)
    x[0, :, 0] = np.arange(16)  # span 0 on y and z: the 1e-12 floor
    np.testing.assert_array_equal(morton_code(torch.from_numpy(x)).numpy(),
                                  np.asarray(jmorton.morton_code(jnp.asarray(x))))


# -- window specs and banded FPS -----------------------------------------------------------

SPEC_GRID = [(S, N, sq) for S in (8, 16, 48, 128, 256, 1024, 16384, 100)
             for N in (8, 64, 100, 256, 2048, 16384) for sq in (16, 128)]


def test_make_window_spec_matches_mpa_tpu():
    admitted = refused = 0
    for S, N, sq in SPEC_GRID:
        try:
            want = JWA.make_window_spec(S, N, sq=sq)
        except ValueError:
            with pytest.raises(ValueError):
                W.make_window_spec(S, N, sq=sq)
            refused += 1
            continue
        got = W.make_window_spec(S, N, sq=sq)
        assert (got.S, got.N, got.sq, got.bn, got.n_chunks, got.window, got.pad) == (
            want.S, want.N, want.sq, want.bn, want.n_chunks, want.window, want.pad), (S, N, sq)
        starts = got.window_start().numpy()
        s = np.arange(S)
        np.testing.assert_array_equal(
            starts, np.asarray(want.block_g((s + want.pad) // want.sq)) * want.bn)
        admitted += 1
    assert admitted > 20 and refused > 20


@pytest.mark.parametrize("min_band,min_samples", [(512, 64), (64, 16), (1, 1)])
def test_pick_fps_bands_matches_mpa_tpu(min_band, min_samples):
    for N, npoint in [(16384, 8192), (8192, 4096), (4096, 2048), (2048, 1024), (256, 128),
                      (100, 50), (96, 24), (512, 7)]:
        kw = dict(min_band=min_band, min_samples=min_samples)
        assert pick_fps_bands(N, npoint, **kw) == jax_pick_fps_bands(N, npoint, **kw)
    assert pick_fps_bands(16384, 8192) == 32  # the semseg window_all shape: 512-point bands


@pytest.mark.parametrize("n_bands", [1, 2, 8])
def test_banded_fps_matches_mpa_tpu(n_bands):
    x, _ = _sorted_pair(4, 2, 256, 256, dup=True)
    want = np.asarray(jax_banded_fps(jnp.asarray(x), 64, n_bands, use_pallas=False))
    got = banded_farthest_point_sample(torch.from_numpy(x), 64, n_bands)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        banded_farthest_point_sample(torch.from_numpy(x), 60, 8)


# -- the windowed kNN -------------------------------------------------------------------------

# (S, N, C, sq): self, down- and up-sampling pairs, feature widths, the sq cap.
KNN_CASES = [(128, 128, 3, 32), (64, 128, 3, 16), (128, 64, 16, 32), (256, 512, 8, 128),
             (32, 256, 3, 128), (128, 128, 64, 128)]


def _same_selection(base, query, got_idx, want_idx):
    """The port's selection against ``mpa_tpu``'s: JAX's CPU einsum and the
    port's channel-order sums can differ in a last bit and swap two
    neighbours whose distances differ in that bit, so the indices agree at
    all but 1% of the entries and each row's selected distances agree in
    value (1e-5 relative, 1e-6 absolute)."""
    assert float((got_idx != want_idx).mean()) <= 0.01
    d = lambda i: W.direct_distance(torch.from_numpy(base), torch.from_numpy(query),  # noqa: E731
                                    torch.from_numpy(np.asarray(i, np.int32))).numpy()
    np.testing.assert_allclose(np.sort(d(got_idx), -1), np.sort(d(want_idx), -1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,N,C,sq", KNN_CASES)
def test_windowed_knn_plain_matches_reference_and_kernel(S, N, C, sq, interpret):
    base, query = _sorted_pair(S + N + C, 2, S, N, C, dup=C == 3)
    spec, jspec = W.make_window_spec(S, N, sq), JWA.make_window_spec(S, N, sq)
    jb, jq = jnp.asarray(base), jnp.asarray(query)
    want = np.asarray(JWA.windowed_knn_reference(8, jb, jq, jspec))
    kernel = np.asarray(JWA.windowed_knn_indices(8, jb, jq, jspec, precision="highest"))
    d, idx = W.windowed_knn_plain(8, torch.from_numpy(base), torch.from_numpy(query), spec)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (2, S, 8)
    _same_selection(base, query, idx.numpy(), want)
    _same_selection(base, query, idx.numpy(), kernel)
    if C == 3:  # coordinates: the same sums, the same indices
        np.testing.assert_array_equal(idx.numpy(), want)
    wd, widx, _ = JWA.windowed_knn_with_spec(8, jb, jq, sq=sq)
    same = idx.numpy() == np.asarray(widx)
    np.testing.assert_allclose(d.numpy()[same], np.asarray(wd)[same], rtol=1e-6, atol=1e-6)
    assert (np.diff(d.numpy(), axis=-1) >= -1e-6).all()  # ascending within the window
    W.check_in_window(idx, spec, "test")


def test_windowed_knn_distances_are_differentiable_as_mpa_tpu():
    S, N, C = 64, 128, 16
    base, query = _sorted_pair(9, 2, S, N, C)
    w = np.random.default_rng(1).standard_normal((2, S, 8)).astype(np.float32)
    want = jax.grad(lambda b, q: jnp.sum(JWA.windowed_knn_with_spec(8, b, q, sq=32)[0] * w),
                    argnums=(0, 1))(jnp.asarray(base), jnp.asarray(query))
    b = torch.from_numpy(base).requires_grad_(True)
    q = torch.from_numpy(query).requires_grad_(True)
    dist, _, spec = W.windowed_knn_with_spec(8, b, q, sq=32)
    (dist * torch.from_numpy(w)).sum().backward()
    assert spec == W.make_window_spec(S, N, sq=32)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)


def test_windowed_knn_checks():
    base, query = (torch.from_numpy(a) for a in _sorted_pair(1, 1, 64, 128))
    with pytest.raises(ValueError, match="multiples of 8"):
        W.windowed_knn_with_spec(8, base, query[:, :8])  # sq = 4: no window
    spec = W.make_window_spec(512, 512)  # four chunks, windows of 256 rows
    with pytest.raises(ValueError, match="the spec is for"):
        W.windowed_transition_attention(torch.ones((1, 512, 2)),
                                        torch.zeros((1, 32, 8), dtype=torch.int32), None, 1, 1,
                                        spec)
    idx = torch.full((1, 512, 8), 300, dtype=torch.int32)  # row 0's window is [0, 256)
    with pytest.raises(ValueError, match="outside"):
        W.check_in_window(idx, spec, "test")


# -- the windowed attention ----------------------------------------------------------------------


def _attention_case(seed, S, N, n_branches, C, with_shifts, sq=32):
    base, query = _sorted_pair(seed, 2, S, N, dup=True)
    jspec = JWA.make_window_spec(S, N, sq=sq)
    idx = np.asarray(JWA.windowed_knn_reference(8, jnp.asarray(base), jnp.asarray(query), jspec))
    rng = np.random.default_rng(seed + 1)
    packed = rng.standard_normal((2, N, n_branches * 2 * C)).astype(np.float32)
    for r in range(n_branches):
        packed[..., 2 * r * C:(2 * r + 1) * C] = np.exp(packed[..., 2 * r * C:(2 * r + 1) * C])
    packed[:, 1::4] = packed[:, 0::4][:, : packed[:, 1::4].shape[1]]  # tied neighbours
    shifts = (rng.standard_normal((2, S, n_branches * C)).astype(np.float32)
              if with_shifts else None)
    gctx = rng.standard_normal((2, S, n_branches * C)).astype(np.float32)
    return W.make_window_spec(S, N, sq=sq), jspec, packed, idx, shifts, gctx


ATTENTION_CASES = [(1, 16, True, 128, 128), (2, 8, True, 64, 128), (2, 5, False, 128, 64),
                   (1, 32, False, 128, 256)]


@pytest.mark.parametrize("n_branches,C,with_shifts,S,N", ATTENTION_CASES)
def test_windowed_attention_matches_pallas_interpret(n_branches, C, with_shifts, S, N,
                                                     interpret):
    spec, jspec, packed, idx, shifts, gctx = _attention_case(S + C, S, N, n_branches, C,
                                                             with_shifts)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    want = np.asarray(JWA.windowed_transition_attention(
        j(packed), j(idx), j(shifts), n_branches, C, jspec, use_pallas=True))
    got = W.windowed_transition_attention(t(packed), t(idx), t(shifts), n_branches, C, spec)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    def jloss(p, s):
        out = JWA.windowed_transition_attention(p, j(idx), s, n_branches, C, jspec,
                                                use_pallas=True)
        return jnp.sum(out * j(gctx))

    orig = JAP.GRAD_SCATTER_PRECISION
    JAP.GRAD_SCATTER_PRECISION = "hilo"  # the Pallas scatter in exact f32
    try:
        argnums = (0, 1) if with_shifts else (0,)
        jgrads = jax.grad(jloss, argnums=argnums)(j(packed), j(shifts))
    finally:
        JAP.GRAD_SCATTER_PRECISION = orig
    p = t(packed).requires_grad_(True)
    s = t(shifts).requires_grad_(True) if with_shifts else None
    (W.windowed_transition_attention(p, t(idx), s, n_branches, C, spec) * t(gctx)).sum().backward()
    tgrads = (p.grad, s.grad) if with_shifts else (p.grad,)
    for g, w in zip(tgrads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    # The CUDA backward's plain version gives autograd's gradients.
    from mpa_tpu_torch.ops.attention import attention_bwd_plain

    dp, ds = attention_bwd_plain(t(packed), t(idx), t(shifts), t(gctx), n_branches, C)
    np.testing.assert_allclose(dp.numpy(), p.grad.numpy(), rtol=0,
                               atol=1e-6 * float(p.grad.abs().max()))
    if with_shifts:
        np.testing.assert_allclose(ds.numpy(), s.grad.numpy(), rtol=0, atol=1e-6)


# -- the windowed scatter-mean ---------------------------------------------------------------------


@pytest.mark.parametrize("S,N,sq", [(128, 128, 32), (64, 256, 16), (256, 64, 32), (32, 512, 16)])
def test_windowed_scatter_mean_matches_pallas_interpret(S, N, sq, interpret):
    fine, coarse = _sorted_pair(S * 7 + N, 2, S, N, dup=True)
    spec, jspec = W.make_window_spec(S, N, sq), JWA.make_window_spec(S, N, sq)
    idx = np.asarray(JWA.windowed_knn_reference(4, jnp.asarray(fine), jnp.asarray(coarse), jspec))
    rng = np.random.default_rng(S)
    feats = rng.standard_normal((2, S, 16)).astype(np.float32)
    g = rng.standard_normal((2, N, 16)).astype(np.float32)
    jfn = lambda f: JWA.windowed_scatter_mean(f, jnp.asarray(idx), N, jspec,  # noqa: E731
                                              use_pallas=True)
    want = np.asarray(jfn(jnp.asarray(feats)))
    want_grad = np.asarray(jax.grad(lambda f: jnp.sum(jfn(f) * g))(jnp.asarray(feats)))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = W.windowed_scatter_mean(f, torch.from_numpy(idx), N, spec)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(f.grad.numpy(), want_grad, rtol=0, atol=1e-5)
    claimed = np.zeros((2, N), bool)
    for b in range(2):
        claimed[b, idx[b].ravel()] = True
    assert (got.detach().numpy()[~claimed] == 0).all()


def test_windowed_ops_on_the_cpu_are_the_exact_plain_versions():
    """On a CPU tensor the windowed attention and scatter-mean are the exact
    ops' plain versions, which compute the same function for any index, as
    ``mpa_tpu`` takes its generic references off the TPU; an index outside
    its window is the caller's error, found by ``check_in_window``."""
    from mpa_tpu_torch.ops.attention import attention_plain
    from mpa_tpu_torch.ops.scatter import scatter_mean_plain

    spec = W.make_window_spec(512, 512)
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 512, (1, 512, 4), generator=g, dtype=torch.int32)
    feats = torch.randn((1, 512, 3), generator=g)
    packed = torch.rand((1, 512, 4), generator=g)
    with pytest.raises(ValueError, match="outside"):
        W.check_in_window(idx, spec, "test")
    assert torch.equal(W.windowed_scatter_mean(feats, idx, 512, spec),
                       scatter_mean_plain(feats, idx, 512)[0])
    assert torch.equal(W.windowed_transition_attention(packed, idx, None, 1, 2, spec),
                       attention_plain(packed, idx, None, 1, 2))


# -- markov_partseg in the window modes -------------------------------------------------------


@pytest.mark.parametrize("mode", ["window", "window_all"])
def test_markov_partseg_window_modes_match_mpa_tpu(mode):
    cfg = dict(npoints=(128, 64, 32, 16), channels=(16, 16, 16, 32, 32), neighbor_mode=mode)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 256, 3)).astype(np.float32)
    onehot = np.eye(16, dtype=np.float32)[rng.integers(0, 16, 2)]
    jm = JaxMarkovPartSeg(**cfg)
    flat = jax_variables(jm, (jnp.asarray(x), jnp.asarray(onehot)))
    want = np.asarray(jax.jit(lambda v, p, o: jm.apply(v, (p, o), train=False))(
        _nest(flat), jnp.asarray(x), jnp.asarray(onehot)))
    tm, unused = port(MarkovPartSeg(**cfg), flat)
    assert unused == []
    with torch.inference_mode():
        got = tm((torch.from_numpy(x), torch.from_numpy(onehot))).numpy()
    assert got.shape == (2, 256, 50) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
