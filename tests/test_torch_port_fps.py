"""Port parity, farthest point sampling, on the CPU.

``mpa_tpu_torch.ops.fps`` against ``mpa_tpu.ops.fps`` on the same numpy
inputs: one start per cloud (``mpa_tpu`` draws them from a key with
``jax.random.randint(key, (B,), 0, N)``; the port is handed the indices that
draw gives), per-band starts of the banded FPS, and feature clouds at the
widths of ``markov_partseg_fp`` (C = 64 to 256). The JAX side runs as the
rest of the suite runs it, on the CPU, where ``mpa_tpu`` takes its XLA loop;
the port takes ``fps_plain``, because the tensors lie on the CPU. The form
rule ``fps_form`` is checked against the kernel's limits at every shape the
port's paths and ``markov_partseg_fp`` give it. ``fps_kernel`` itself is
held against ``fps_plain`` on the card (``tests/test_torch_port_cuda.py``).

Tolerance: indices exactly equal. At C = 3 both sides sum the three squares
in channel order; at larger C, XLA's CPU reduction may add in another order,
so a pick could flip on a last-bit tie; the seeds here have none.
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

from mpa_tpu.ops import banded_farthest_point_sample as jax_banded_fps  # noqa: E402
from mpa_tpu.ops.fps import farthest_point_sample as jax_fps  # noqa: E402
from mpa_tpu_torch.ops import fps as F  # noqa: E402


def _cloud(seed, shape, dup=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dup:  # exact duplicates: every 5th point copies its predecessor
        x[:, 5::5] = x[:, 4::5][:, : x[:, 5::5].shape[1]]
    return x


def _starts(key, B, N):
    """The starts ``mpa_tpu`` draws for ``key``: ``randint(key, (B,), 0, N)``."""
    return np.array(jax.random.randint(key, (B,), 0, N, dtype=jnp.int32))


@pytest.mark.parametrize("B,N,npoint,C,dup,seed", [
    (4, 256, 64, 3, False, 0), (3, 200, 50, 3, True, 1), (5, 64, 64, 3, False, 2),
    (2, 100, 37, 6, True, 3),
])
def test_per_cloud_starts_match_mpa_tpu_key(B, N, npoint, C, dup, seed):
    pts = _cloud(seed, (B, N, C), dup)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_fps(jnp.asarray(pts), npoint, key=key))
    start = torch.from_numpy(_starts(key, B, N))
    assert len(set(start.tolist())) > 1 or B == 1  # the clouds start apart
    got = F.farthest_point_sample(torch.from_numpy(pts), npoint, start_idx=start)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 0].numpy(), start.numpy())


@pytest.mark.parametrize("n_bands", [2, 8])
def test_banded_per_band_starts_match_mpa_tpu_key(n_bands):
    B, N, npoint = 2, 256, 64
    x = _cloud(4, (B, N, 3), dup=True)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_banded_fps(jnp.asarray(x), npoint, n_bands, key=key, use_pallas=False))
    # mpa_tpu folds the bands into the batch and draws one band-local start each.
    start = torch.from_numpy(_starts(key, B * n_bands, N // n_bands)).reshape(B, n_bands)
    got = F.banded_farthest_point_sample(torch.from_numpy(x), npoint, n_bands, start_idx=start)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,npoint,C", [(256, 128, 64), (128, 64, 128), (64, 32, 256)])
@pytest.mark.parametrize("keyed", [False, True])
def test_feature_clouds_match_mpa_tpu(N, npoint, C, keyed):
    """The widths of ``markov_partseg_fp``'s feature FPS (la0-la4: 64, 64,
    64, 128, 256 channels), at small N."""
    B = 3
    pts = _cloud(N + C, (B, N, C))
    key = jax.random.PRNGKey(C) if keyed else None
    want = np.asarray(jax_fps(jnp.asarray(pts), npoint, key=key))
    start = torch.from_numpy(_starts(key, B, N)) if keyed else 0
    got = F.farthest_point_sample(torch.from_numpy(pts), npoint, start_idx=start)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("start", [0, 5, 63])
def test_equal_starts_tensor_equals_the_scalar(start):
    pts = torch.from_numpy(_cloud(9, (3, 64, 3), dup=True))
    scalar = F.farthest_point_sample(pts, 16, start_idx=start)
    tensor = F.farthest_point_sample(pts, 16, start_idx=torch.full((3,), start))
    assert torch.equal(scalar, tensor)
    assert torch.equal(F.fps_plain(pts, 16, torch.full((3,), start, dtype=torch.int32)), scalar)
    assert torch.equal(F.fps_plain(pts, 16, start), scalar)


def test_all_coincident_and_npoint_equal_to_n():
    pts = torch.zeros((2, 16, 3))  # every distance 0: each step takes index 0
    got = F.farthest_point_sample(pts, 16, start_idx=torch.tensor([3, 0]))
    assert got[0, 0] == 3 and bool((got[0, 1:] == 0).all()) and bool((got[1] == 0).all())
    cloud = torch.from_numpy(_cloud(10, (2, 40, 3)))
    full = F.farthest_point_sample(cloud, 40)
    assert all(sorted(row.tolist()) == list(range(40)) for row in full)  # each point once


@pytest.mark.parametrize("start,match", [
    (torch.tensor([0, 64]), "out of"), (torch.tensor([-1, 0]), "out of"),
    (torch.tensor([0, 1, 2]), "integer indices"), (torch.tensor([0.0, 1.0]), "integer indices"),
    (64, "out of"),
])
def test_bad_starts_raise(start, match):
    pts = torch.zeros((2, 64, 3))
    with pytest.raises(ValueError, match=match):
        F.farthest_point_sample(pts, 8, start_idx=start)


def _fits(B, N, C, form):
    """``fps_kernel``'s limits (``mpa_fps`` in ``fps.cu``) for ``form``."""
    resident, cs, nw = form
    L = -(-N // cs)
    if not resident:
        return (cs in (1, 2, 4, 8, 16) and nw == (8 if cs <= 2 else 4)
                and F._slice_bytes(N, C, cs, nw) <= F.SMEM_BYTES)
    if not (1 <= nw <= 16 if cs == 1 else cs in (4, 8) and nw == 4):
        return False
    ppt = 1
    while ppt < 32 and ppt * 32 * nw < L:
        ppt *= 2
    limit = 1024 if ppt <= 4 else 4096 // ppt
    return C == 3 and 12 * N <= F.RESIDENT_BYTES and ppt * 32 * nw >= L and 32 * nw <= limit


# Every FPS launch shape of the port's paths (cls, part-seg, semseg window_all
# bands, repsurf, the 16384-point window request) and markov_partseg_fp's
# feature clouds at B = 32 and B = 2, and ragged ones.
PATH_SHAPES = [(64, 1024, 3), (64, 512, 3), (64, 256, 3), (64, 128, 3), (64, 64, 3),
               (32, 2048, 3), (32, 1024, 3), (32, 512, 3), (32, 256, 3),
               (128, 512, 3), (16, 512, 3), (2, 16384, 3), (1, 16384, 3), (2, 4096, 3),
               (32, 2048, 64), (32, 1024, 64), (32, 512, 64), (32, 256, 128), (32, 128, 256),
               (2, 2048, 64), (2, 128, 256), (3, 100, 3), (2, 1, 3), (3, 512, 6), (2, 20000, 3)]


@pytest.mark.parametrize("B,N,C", PATH_SHAPES)
def test_fps_form_is_within_the_kernel_limits(B, N, C):
    form = F.fps_form(B, N, C)
    assert _fits(B, N, C, form), form
    assert form[0] == (C == 3 and N <= 16384)


def test_fps_form_spreads_large_clouds_and_refuses_what_no_cluster_holds():
    assert F.fps_form(2, 16384, 3)[1] == 8  # 16384 points over 8 CTAs
    assert F.fps_form(64, 1024, 3)[1] == 1  # small clouds keep one block
    assert F.fps_form(32, 2048, 64)[1] >= 4  # 512 KB a cloud: at least four CTAs
    with pytest.raises(ValueError, match="shared memory of 16 CTAs"):
        F.fps_form(1, 65536, 64)


# The card tests' shapes, one for each form fps_form picks
# (tests/test_torch_port_cuda.py FPS_FORM_SHAPES), and the form each picks.
FORM_SHAPES = {(100, 3): (True, 1, 1), (1000, 3): (True, 1, 15), (2048, 3): (True, 1, 16),
               (3000, 3): (True, 4, 4), (5001, 3): (True, 8, 4), (256, 5): (False, 1, 8),
               (500, 5): (False, 2, 8), (1000, 5): (False, 4, 4), (2000, 5): (False, 8, 4),
               (3000, 5): (False, 16, 4)}


@pytest.mark.parametrize("N,C", sorted(FORM_SHAPES))
def test_card_test_shapes_reach_their_forms(N, C):
    assert F.fps_form(3, N, C) == FORM_SHAPES[(N, C)]


def test_every_form_fps_form_picks_has_a_card_test_shape():
    """Over clouds of 1 to 20000 points at 3 to 256 channels, fps_form picks
    a cluster size and a warp count that some card-test shape reaches (the
    one-block warp count apart, which only sets how many threads share N)."""
    covered = {(r, cs, nw if cs > 1 or not r else 0) for r, cs, nw in FORM_SHAPES.values()}
    picked = set()
    for C in (3, 5, 64, 128, 256):
        for N in list(range(1, 4200, 7)) + list(range(4200, 20001, 97)):
            try:
                r, cs, nw = F.fps_form(2, N, C)
            except ValueError:
                continue
            assert _fits(2, N, C, (r, cs, nw)), (N, C)
            picked.add((r, cs, nw if cs > 1 or not r else 0))
    assert picked == covered
