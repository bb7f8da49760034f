"""The hard inputs of the kNN, windowed kNN and attention kernels, on the
CPU: the port's plain versions against ``mpa_tpu`` on the same inputs.

The card tests (``tests/test_torch_port_cuda.py``) hold each kernel equal to
its plain version on these inputs at full size; here, at small sizes, the
plain versions are held to ``mpa_tpu`` (JAX on the CPU, as its own tests run
it), so the chain kernel = plain = ``mpa_tpu`` holds on them too:

- ``knn_plain`` against ``mpa_tpu.ops.knn.knn``: identical points (every
  distance 0), distances that fall as the index rises, an integer grid (many
  exact ties), k = 9 at C = 3 (the umbrella), k = 64 at C = 600 with S = 1,
  C = 9 and C = 130 (widths that are not a multiple of 4) with N and S ragged.
  Indices exactly equal; distances within 1e-5 relative, with an absolute
  floor of 1e-6 of |q|^2 + |b|^2 (JAX's CPU distances round in their own
  order, and the expanded form cancels).
- ``windowed_knn_plain`` against ``mpa_tpu``'s ``windowed_knn_reference``
  and its Pallas kernel ``windowed_knn_indices`` in interpret mode (as
  ``tests/test_window_attention.py`` runs it): identical points, an integer
  grid, distances that fall as the index rises, C = 5, 9 and 130, k = 1, 16,
  17 and 32, sq = 8 and 64 so that query chunks are short. Indices exactly
  equal; distances within 1e-6 of ``mpa_tpu``'s (the tolerance of
  ``tests/test_torch_port_window.py``, for its sums in XLA's order).
- ``attention_plain`` against ``mpa_tpu``'s ``transition_attention`` (its
  XLA reference, and its Pallas kernels in interpret mode): a hot node, a
  node named twice by one query, several neighbours tied for the maximum,
  an eps-floored denominator, K = 5, 8, 16 and 64; rtol 1e-5.
- ``attention_plain`` on window-constrained indices (``mpa_tpu``'s
  windowed kNN on Morton-ordered clouds) against ``_wattn_fwd``, the Pallas
  kernel of ``mpa_tpu``'s windowed attention forward, in interpret mode:
  la0's self-window of 256 rows, sq = 8 and 32, K = 5, 8, 16 and 33, c = 4,
  7 and 16, with and without shifts, neighbours tied for the maximum and an
  eps-floored query; rtol 1e-5.
- ``scatter_mean_plain`` against ``mpa_tpu``'s scatter-mean kernel
  (``scatter_mean_upsample_pallas``'s ``_scatter_sum_count``) in interpret
  mode and, where every index lies in ``[0, N)`` (``mpa_tpu``'s segment
  form defines no other), ``mpa_tpu.ops.scatter.scatter_mean_upsample``: a
  slot with no claim and one with more than 32, one coarse point naming a
  slot twice, indices outside ``[0, N)``, N not a multiple of a block's
  slots, C = 1, 31, 33, 130 and 512, B = 1. Counts exactly equal, means
  within 1e-6 relative with an absolute floor of 1e-6 (the Pallas kernel
  sums by a matrix product, split into bf16 hi and lo parts).
- ``attention_bwd_plain`` against ``mpa_tpu``'s custom-VJP math and
  ``jax.grad`` of ``transition_attention`` (as
  ``tests/test_torch_port_train.py`` does): a hot node, unnamed nodes, a
  node named twice by one query, several neighbours tied for the maximum,
  an eps-floored denominator; rtol 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)
from test_torch_port_cuda import (  # noqa: E402
    FLOORED, _attention_inputs, _morton_pair, attention_case, knn_cloud, scatter_mean_case,
)

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mpa_tpu.ops.knn import knn as jax_knn  # noqa: E402
from mpa_tpu.ops.pallas.scatter_pallas import _scatter_sum_count  # noqa: E402
from mpa_tpu.ops.scatter import scatter_mean_upsample as jax_scatter_mean  # noqa: E402
from mpa_tpu.ops.pallas import window_attention as JWA  # noqa: E402
from mpa_tpu.ops.pallas.attention_pallas import _bwd_scatter_xla  # noqa: E402
from mpa_tpu.ops.pallas.attention_pallas import transition_attention as jax_attention  # noqa: E402
from mpa_tpu_torch.ops.attention import attention_bwd_plain, attention_plain  # noqa: E402
from mpa_tpu_torch.ops.knn import knn_plain  # noqa: E402
from mpa_tpu_torch.ops.scatter import scatter_mean_plain  # noqa: E402
from mpa_tpu_torch.ops.window import make_window_spec, windowed_knn_plain  # noqa: E402


# (k, N, S, C, dup, self_query, cloud, B): the card cases at small sizes.
KNN_CPU_CASES = [
    (8, 100, 30, 3, False, False, "identical", 2),
    (8, 40, 40, 16, False, True, "identical", 2),
    (8, 256, 16, 3, False, False, "falling", 2),
    (16, 200, 20, 16, False, False, "falling", 2),
    (16, 256, 64, 3, False, False, "grid", 2),
    (8, 120, 120, 8, False, True, "grid", 2),
    (9, 256, 256, 3, False, True, "normal", 2),
    (64, 200, 1, 600, False, False, "normal", 2),
    (8, 256, 256, 64, True, True, "normal", 2),
    (16, 777, 50, 9, False, False, "normal", 2),
    (8, 301, 60, 130, False, False, "normal", 2),
]


@pytest.mark.parametrize("k,N,S,C,dup,self_query,cloud,B", KNN_CPU_CASES)
def test_knn_plain_matches_mpa_tpu_on_kernel_cases(k, N, S, C, dup, self_query, cloud, B):
    base, query = knn_cloud(cloud, B, N, S, C, dup, self_query)
    wd, wi = jax_knn(k, jnp.asarray(base), jnp.asarray(query))
    gd, gi = knn_plain(k, torch.from_numpy(base), torch.from_numpy(query))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # The expanded form |q|^2 + |b|^2 - 2 q.b cancels: its rounding is an ulp
    # or so of |q|^2 + |b|^2, the floor of the absolute tolerance.
    norms = (base ** 2).sum(-1).max() + (query ** 2).sum(-1).max()
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-6 * norms + 1e-6)
    if cloud == "identical":
        assert not gd.numpy().any()
        np.testing.assert_array_equal(gi.numpy(), np.broadcast_to(np.arange(k), gi.shape))


# (n_branches, with_shift, N, S, K, c, case): the card cases at small sizes;
# every one also plants an eps-floored query, a duplicate node and a K-way tie.
ATTENTION_CPU_CASES = [
    (2, True, 64, 48, 8, 8, "hot"),
    (1, False, 64, 40, 16, 12, "hot"),
    (2, True, 80, 40, 8, 8, "unnamed"),
    (1, True, 60, 30, 33, 6, "unnamed"),
    (2, True, 64, 48, 8, 8, "twice"),
    (2, False, 64, 48, 8, 12, "ties"),
    (1, True, 40, 30, 64, 4, "ties"),
    (1, True, 128, 128, 8, 16, "plain"),  # la0's form: one branch, shifts, K = 8
]


@pytest.mark.parametrize("n_branches,with_shift,N,S,K,c,case", ATTENTION_CPU_CASES)
def test_attention_bwd_plain_matches_mpa_tpu_on_kernel_cases(n_branches, with_shift, N, S, K,
                                                             c, case):
    packed, idx, shifts, gctx = _attention_inputs("cpu", n_branches, with_shift, N, S, K, c)
    unnamed = attention_case(case, packed, idx)
    p, i, g = packed.numpy(), idx.numpy(), gctx.numpy()
    sh = None if shifts is None else shifts.numpy()
    B = p.shape[0]
    G = np.take_along_axis(p, i.reshape(B, S * K)[..., None], 1).reshape(B, S, K, -1)
    want_p, want_s = _bwd_scatter_xla(jnp.asarray(G), None if sh is None else jnp.asarray(sh),
                                      jnp.asarray(g), jnp.asarray(i), N, n_branches, c)
    want_p = np.asarray(want_p)

    def jloss(pk, s):
        return jnp.sum(jax_attention(pk, jnp.asarray(i), s, n_branches, c) * g)

    if with_shift:
        auto_p, auto_s = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(sh))
    else:
        auto_p = jax.grad(lambda pk: jloss(pk, None))(jnp.asarray(p))
    auto_p = np.asarray(auto_p)
    # jax.grad is NaN on the eps-floored nodes' E columns only (0 / eps**2).
    finite = np.isfinite(auto_p)
    floored = np.zeros_like(finite)
    for r in range(n_branches):
        floored[:, N - FLOORED:, 2 * r * c:(2 * r + 1) * c] = True
    assert not (~finite & ~floored).any()

    got_p, got_s = attention_bwd_plain(packed, idx, shifts, gctx, n_branches, c)
    got_p = got_p.numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_p[finite], auto_p[finite], rtol=1e-5, atol=1e-6)
    if unnamed is not None:
        assert not got_p[:, unnamed.numpy()].any()
    if with_shift:
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(auto_s), rtol=1e-5, atol=1e-6)
    else:
        assert got_s is None


# (S, N, C, sq, k, cloud): the card's windowed-kNN cases at small sizes.
WINDOW_KNN_CPU_CASES = [
    (64, 128, 3, 8, 8, "identical"),
    (64, 64, 16, 128, 8, "identical"),
    (128, 256, 5, 64, 16, "grid"),
    (64, 128, 9, 8, 17, "grid"),
    (128, 128, 3, 128, 32, "grid"),
    (128, 256, 5, 128, 1, "falling"),
    (64, 128, 64, 64, 16, "falling"),
    (64, 128, 130, 64, 32, "falling"),
    (128, 256, 3, 64, 8, "normal"),
]


@pytest.mark.parametrize("S,N,C,sq,k,cloud", WINDOW_KNN_CPU_CASES)
def test_windowed_knn_plain_matches_mpa_tpu_on_kernel_cases(S, N, C, sq, k, cloud):
    base, query = knn_cloud(cloud, 2, N, S, C, False, False, seed=S + C)
    spec, jspec = make_window_spec(S, N, sq), JWA.make_window_spec(S, N, sq)
    jb, jq = jnp.asarray(base), jnp.asarray(query)
    want = np.asarray(JWA.windowed_knn_reference(k, jb, jq, jspec))
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(JWA.windowed_knn_indices(k, jb, jq, jspec, precision="highest"))
    got_d, got_i = windowed_knn_plain(k, torch.from_numpy(base), torch.from_numpy(query), spec)
    np.testing.assert_array_equal(got_i.numpy(), want)
    np.testing.assert_array_equal(got_i.numpy(), kernel)
    want_d, _, _ = JWA.windowed_knn_with_spec(k, jb, jq, sq=sq)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=1e-6)
    if cloud == "identical":
        assert not got_d.numpy().any()


# (n_branches, with_shift, N, S, K, c, case): the card's forward cases at
# small sizes.
ATTENTION_FWD_CPU_CASES = [
    (2, True, 64, 48, 8, 8, "hot"),
    (2, True, 60, 40, 16, 7, "hot"),
    (2, True, 64, 48, 8, 8, "twice"),
    (2, False, 64, 48, 8, 12, "ties"),
    (1, True, 40, 30, 5, 7, "ties"),
    (1, True, 40, 30, 64, 4, "ties"),
    (1, True, 128, 128, 8, 16, "plain"),
]


@pytest.mark.parametrize("n_branches,with_shift,N,S,K,c,case", ATTENTION_FWD_CPU_CASES)
def test_attention_plain_matches_mpa_tpu_on_kernel_cases(n_branches, with_shift, N, S, K, c,
                                                         case):
    packed, idx, shifts, _ = _attention_inputs("cpu", n_branches, with_shift, N, S, K, c)
    attention_case(case, packed, idx)
    args = (jnp.asarray(packed.numpy()), jnp.asarray(idx.numpy()),
            None if shifts is None else jnp.asarray(shifts.numpy()))
    got = attention_plain(packed, idx, shifts, n_branches, c).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jax_attention(*args, n_branches, c))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(jax_attention(*args, n_branches, c, use_pallas=True))
    np.testing.assert_allclose(got, kernel, rtol=1e-5, atol=1e-6)


# (n_branches, with_shift, S, N, c, K, sq, case): the card's windowed-forward
# cases at small sizes.
WINDOW_ATTENTION_FWD_CPU_CASES = [
    (1, True, 256, 256, 16, 8, 128, "ties"),  # la0's self-window: 256 rows
    (2, True, 64, 128, 7, 5, 8, "floored"),
    (2, False, 64, 128, 16, 16, 32, "ties"),
    (1, True, 128, 256, 4, 33, 64, "floored"),
    (1, False, 64, 64, 7, 8, 16, "plain"),
]


@pytest.mark.parametrize("n_branches,with_shift,S,N,c,K,sq,case", WINDOW_ATTENTION_FWD_CPU_CASES)
def test_windowed_attention_plain_matches_mpa_tpu_kernel(n_branches, with_shift, S, N, c, K,
                                                         sq, case):
    base, query = _morton_pair(S + N + K, 2, S, N, 3, "cpu", dup=True)
    jspec = JWA.make_window_spec(S, N, sq)
    idx = np.array(JWA.windowed_knn_reference(K, jnp.asarray(base.numpy()),
                                              jnp.asarray(query.numpy()), jspec))
    rng = np.random.default_rng(S + c)
    packed = rng.standard_normal((2, N, n_branches * 2 * c)).astype(np.float32)
    e_cols = np.concatenate([np.arange(2 * r * c, (2 * r + 1) * c) for r in range(n_branches)])
    packed[..., e_cols] = np.exp(packed[..., e_cols])
    if case == "ties":
        packed[:, 1::2] = packed[:, 0::2]
    elif case == "floored":  # query 1's neighbours all have E = 0
        for b in range(2):
            packed[b, idx[b, 1][:, None], e_cols[None, :]] = 0.0
    shifts = (rng.standard_normal((2, S, n_branches * c)).astype(np.float32)
              if with_shift else None)
    got = attention_plain(torch.from_numpy(packed), torch.from_numpy(idx),
                          None if shifts is None else torch.from_numpy(shifts),
                          n_branches, c).numpy()
    assert np.isfinite(got).all()
    if case == "floored":  # the denominator is 0 and floored at 1e-20
        assert not packed[0, idx[0, 1]][:, e_cols].any()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JWA._wattn_fwd(jnp.asarray(packed), jnp.asarray(idx),
                                         None if shifts is None else jnp.asarray(shifts),
                                         n_branches, c, jspec))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# (case, B, S, K, N, C): the card's scatter-mean cases at small sizes.
SCATTER_MEAN_CPU_CASES = [
    ("zero_and_many", 2, 200, 8, 100, 16),
    ("twice", 2, 40, 8, 90, 33),
    ("outside", 2, 40, 8, 90, 31),
    ("plain", 1, 100, 8, 300, 1),
    ("plain", 2, 50, 3, 70, 130),
    ("zero_and_many", 1, 180, 4, 40, 512),
]


@pytest.mark.parametrize("case,B,S,K,N,C", SCATTER_MEAN_CPU_CASES)
def test_scatter_mean_plain_matches_mpa_tpu_on_kernel_cases(case, B, S, K, N, C):
    feats, idx = scatter_mean_case(case, B, S, K, N, C)
    got, got_count = scatter_mean_plain(torch.from_numpy(feats), torch.from_numpy(idx), N)
    with pltpu.force_tpu_interpret_mode():
        summed, cnt = _scatter_sum_count(jnp.asarray(feats), jnp.asarray(idx), N, n_tile=128)
    np.testing.assert_array_equal(got_count.numpy(), np.asarray(cnt))
    want = np.asarray(summed) / np.maximum(np.asarray(cnt), 1.0)[..., None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if case != "outside":
        seg = np.asarray(jax_scatter_mean(jnp.asarray(feats), jnp.asarray(idx), N,
                                          use_pallas=False))
        np.testing.assert_allclose(got.numpy(), seg, rtol=1e-6, atol=1e-6)
    counts = got_count.numpy()
    if case == "zero_and_many":
        assert (counts == 0).any() and counts.max() > 32
        assert not got.numpy()[counts == 0].any()
    if case == "twice":
        assert (idx[:, 3] == 11).sum() == 2 * B
