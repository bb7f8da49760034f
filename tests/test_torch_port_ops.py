"""Port parity, ops: each ``mpa_tpu_torch.ops`` function against its
``mpa_tpu`` twin on the CPU, on the same numpy inputs made from a seed.

The JAX side runs as the rest of the suite runs it (JAX on the CPU, where
``mpa_tpu`` takes its plain references); the torch side takes its plain
versions, because the tensors lie on the CPU. The CUDA kernels are held
against these plain versions on the card (tests marked ``cuda``, and
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpa_tpu.ops.fps import farthest_point_sample as jax_fps
from mpa_tpu.ops.gather import index_points as jax_index_points
from mpa_tpu.ops.knn import knn as jax_knn
from mpa_tpu.ops.pairwise import square_distance as jax_square_distance
from mpa_tpu.ops.pallas.attention_pallas import transition_attention as jax_attention
from mpa_tpu_torch import kernels
from mpa_tpu_torch.ops import (
    farthest_point_sample,
    index_points,
    knn,
    square_distance,
    transition_attention,
)
from mpa_tpu_torch.ops.attention import attention_bwd_cuda, attention_cuda
from mpa_tpu_torch.ops.fps import fps_cuda
from mpa_tpu_torch.ops.gather import gather_cuda, scatter_add_cuda
from mpa_tpu_torch.ops.knn import knn_cuda


def _cloud(seed, shape, dup=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dup:  # exact duplicates: every 5th point copies its predecessor
        x[:, 5::5] = x[:, 4::5][:, : x[:, 5::5].shape[1]]
    return x


@pytest.mark.parametrize("C", [3, 16])
def test_square_distance(C):
    a, b = _cloud(0, (2, 40, C)), _cloud(1, (2, 56, C))
    want = np.asarray(jax_square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got >= 0).all()


@pytest.mark.parametrize(
    "k,N,S,C,dup,self_query",
    [
        (8, 128, 48, 3, False, False),
        (8, 96, 96, 3, True, True),  # la0's self-query, with exact duplicates
        (16, 80, 20, 32, False, False),  # feature-space kNN
        (8, 64, 64, 8, True, True),
    ],
)
def test_knn(k, N, S, C, dup, self_query):
    # Unit-variance points scaled by 1/sqrt(C): distances stay O(1), where a
    # float32 ulp is well below the 1e-6 tolerance.
    base = _cloud(2, (2, N, C), dup=dup) / np.float32(np.sqrt(C))
    query = base if self_query else _cloud(3, (2, S, C)) / np.float32(np.sqrt(C))
    wd, wi = jax_knn(k, jnp.asarray(base), jnp.asarray(query))
    gd, gi = knn(k, torch.from_numpy(base), torch.from_numpy(query))
    assert gi.dtype == torch.int32 and tuple(gi.shape) == (2, S, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-6)


def test_knn_duplicate_ties_go_to_lowest_index():
    base = np.zeros((1, 6, 3), np.float32)
    base[0, 3] = 1.0  # five coincident points and one outlier
    d, i = knn(4, torch.from_numpy(base), torch.from_numpy(base[:, :1]))
    np.testing.assert_array_equal(i.numpy()[0, 0], [0, 1, 2, 4])
    np.testing.assert_array_equal(d.numpy()[0, 0], [0, 0, 0, 0])


@pytest.mark.parametrize("N,npoint,C,dup", [(256, 64, 3, False), (200, 50, 3, True), (64, 16, 6, False)])
def test_farthest_point_sample(N, npoint, C, dup):
    pts = _cloud(4, (3, N, C), dup=dup)
    want = np.asarray(jax_fps(jnp.asarray(pts), npoint))
    got = farthest_point_sample(torch.from_numpy(pts), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_farthest_point_sample_all_coincident():
    pts = np.zeros((2, 16, 3), np.float32)  # every distance 0: argmax takes index 0
    want = np.asarray(jax_fps(jnp.asarray(pts), 5))
    got = farthest_point_sample(torch.from_numpy(pts), 5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("idx_shape,C", [((2, 30), 3), ((2, 12, 8), 20)])
def test_index_points(idx_shape, C):
    pts = _cloud(5, (2, 50, C))
    idx = np.random.default_rng(6).integers(0, 50, idx_shape).astype(np.int32)
    want = np.asarray(jax_index_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = index_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_branches", [1, 2])
@pytest.mark.parametrize("with_shift", [False, True])
def test_transition_attention(n_branches, with_shift):
    B, N, S, K, c = 2, 40, 24, 8, 16
    rng = np.random.default_rng(7)
    packed = rng.standard_normal((B, N, n_branches * 2 * c)).astype(np.float32)
    for r in range(n_branches):  # E channels are positive exp(...) numerators
        e = slice(2 * r * c, (2 * r + 1) * c)
        packed[..., e] = np.exp(packed[..., e])
    idx = rng.integers(0, N, (B, S, K)).astype(np.int32)
    shifts = rng.standard_normal((B, S, n_branches * c)).astype(np.float32) if with_shift else None
    want = np.asarray(jax_attention(
        jnp.asarray(packed), jnp.asarray(idx),
        None if shifts is None else jnp.asarray(shifts), n_branches, c,
    ))
    got = transition_attention(
        torch.from_numpy(packed), torch.from_numpy(idx),
        None if shifts is None else torch.from_numpy(shifts), n_branches, c,
    ).numpy()
    assert got.shape == (B, S, n_branches * c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    pts = torch.from_numpy(_cloud(8, (1, 32, 3))).requires_grad_(True)
    idx = farthest_point_sample(pts, 8)
    dist, nbr = knn(4, pts, pts)
    packed = torch.cat([index_points(pts, idx).exp(), pts[:, :8]], dim=-1)
    out = transition_attention(packed, nbr[:, :8] % 8, None, 1, 3)
    (out.sum() + dist.sum()).backward()  # the backward takes the plain ops too
    assert pts.grad is not None and torch.isfinite(pts.grad).all()
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}


@pytest.mark.parametrize(
    "call",
    [
        lambda t: knn_cuda(4, t, t),
        lambda t: fps_cuda(t, 4),
        lambda t: gather_cuda(t, torch.zeros((1, 4), dtype=torch.int32)),
        lambda t: attention_cuda(torch.ones((1, 8, 6)), torch.zeros((1, 2, 2), dtype=torch.int32), None, 1, 3),
        lambda t: scatter_add_cuda(t, torch.zeros((1, 8), dtype=torch.int32), 8),
        lambda t: attention_bwd_cuda(torch.ones((1, 8, 6)), torch.zeros((1, 2, 2), dtype=torch.int32),
                                     None, torch.ones((1, 2, 3)), 1, 3),
    ],
    ids=["knn", "fps", "gather", "attention", "scatter_add", "attention_bwd"],
)
def test_cuda_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError):
        call(torch.zeros((1, 8, 3)))
