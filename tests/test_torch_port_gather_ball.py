"""``gather_rows_kernel``'s and ``ball_query_kernel``'s Python side, on the
CPU: the forms the wrappers pick, and the plain versions the card tests hold
the kernels to, against ``mpa_tpu``.

- ``gather_form`` at every case of ``tests/test_torch_port_cuda.py``'s
  ``GATHER_CASES`` (the paths' widths, W = 1 to 512, E = 1, views 4, 8 and
  12 bytes off): float4, float2 or scalar columns by width and alignment,
  and two columns a thread on long launches.
- ``ball_query_form``: eight centres a warp, halved while the launch is
  short of warps, at the three repsurf stages and at the edges.
- ``gather_plain`` bit-equal (``np.array_equal``) to ``mpa_tpu``'s
  ``loop_gather_rows`` (its Pallas kernel in interpret mode, as
  ``tests/test_pallas_kernels.py`` runs it) at W = 1, 3, 10, 64 and 256,
  with E = 1 and B = 1 among them.
- ``ball_query_plain`` on ``test_torch_port_cuda.hit_cloud``'s clouds
  (centres with 0, 1, exactly nsample and more hits; C = 3 and 6) against
  ``mpa_tpu``'s ``ball_query``, and on NaN rows and centres, which no ball
  admits on either side.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)
from test_torch_port_cuda import GATHER_CASES, hit_cloud  # noqa: E402

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mpa_tpu.ops.ball_query import ball_query as jax_ball_query  # noqa: E402
from mpa_tpu.ops.pallas.gather_pallas import loop_gather_rows  # noqa: E402
from mpa_tpu_torch.ops.ball_query import (  # noqa: E402
    FILL_WARPS, MAX_CENTRES, ball_query, ball_query_form, ball_query_plain,
)
from mpa_tpu_torch.ops.gather import (  # noqa: E402
    GATHER_THREADS, MANY_BLOCKS, gather_form, gather_plain,
)


def view_at(shape, offset):
    """A contiguous float32 CPU view of ``shape`` that starts ``offset``
    floats past a 16-byte boundary of its buffer."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset + 4)
    start = (4 - buf.data_ptr() % 16 // 4) % 4
    return buf[start + offset:start + offset + n].view(shape)


@pytest.mark.parametrize("B,N,E,W,offset,form", GATHER_CASES)
def test_gather_form(B, N, E, W, offset, form):
    assert gather_form(view_at((B, N, W), offset), B * E) == form


def test_gather_form_doubles_the_columns_a_thread_on_long_launches():
    for B, N, E, W in [(64, 1024, 512, 64), (2, 16384, 8192, 64), (64, 64, 32, 256),
                       (64, 2048, 16384, 3), (32, 2048, 8192, 64), (64, 1024, 9216, 3)]:
        vec, elems = gather_form(view_at((B, N, W), 0), B * E)
        blocks = -(-B * E * W // vec // GATHER_THREADS)
        assert elems == (2 if blocks >= MANY_BLOCKS else 1)


@pytest.mark.parametrize("B,S,form", [
    (64, 512, 8),  # repsurf sa1: 4096 warps
    (64, 128, 2),  # sa2
    (64, 32, 1),  # sa3
    (40, 500, 8),
    (4, 512, 1),
    (1, 10, 1),
    (4096, 32, 8),
])
def test_ball_query_form(B, S, form):
    g = ball_query_form(B, S)
    assert g == form
    assert g == MAX_CENTRES or g == 1 or B * -(-S // (2 * g)) < FILL_WARPS <= B * -(-S // g)


@pytest.mark.parametrize("B,N,E,W", [(2, 100, 37, 1), (1, 64, 1, 3), (2, 300, 700, 10),
                                     (2, 128, 96, 64), (1, 40, 1, 256), (2, 64, 33, 256)])
def test_gather_plain_matches_loop_gather_rows(B, N, E, W):
    rng = np.random.default_rng(W + E)
    pts = rng.standard_normal((B, N, W)).astype(np.float32)
    idx = rng.integers(0, N, (B, E)).astype(np.int32)
    got = gather_plain(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(loop_gather_rows(jnp.asarray(pts), jnp.asarray(idx)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.take_along_axis(pts, idx[..., None].astype(np.int64), 1))


@pytest.mark.parametrize("B,N,S,C,ns", [(2, 300, 40, 3, 8), (1, 500, 33, 6, 16),
                                        (2, 1000, 77, 3, 24)])
def test_ball_query_plain_hit_classes_match_mpa_tpu(B, N, S, C, ns):
    xyz, new_xyz, kinds = hit_cloud(B, N, S, C, ns)
    got = ball_query_plain(0.3, ns, torch.from_numpy(xyz), torch.from_numpy(new_xyz)).numpy()
    hits = (got < N).sum(-1)
    assert set(kinds.flatten()) == {0, 1, 2, 3}
    assert (hits[kinds == 0] == 0).all() and (hits[kinds == 1] == 1).all()
    assert (hits[kinds >= 2] == ns).all()
    full = ball_query(0.3, ns, torch.from_numpy(xyz), torch.from_numpy(new_xyz)).numpy()
    want = np.asarray(jax_ball_query(0.3, ns, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    np.testing.assert_array_equal(full, want)


def test_ball_query_plain_leaves_nan_rows_and_centres_out():
    rng = np.random.default_rng(4)
    xyz = (0.2 * rng.standard_normal((2, 200, 3))).astype(np.float32)
    xyz[0, 3, 1] = np.nan
    xyz[1, 150:, 0] = np.nan
    new_xyz = xyz[:, :40].copy()
    new_xyz[1, 5, 2] = np.nan
    got = ball_query_plain(0.2, 16, torch.from_numpy(xyz), torch.from_numpy(new_xyz)).numpy()
    assert not (got[0] == 3).any() and (got[1, 5] == 200).all() and (got[1] < 150).any()
    assert ((got[1] < 150) | (got[1] == 200)).all()
    want = np.asarray(jax_ball_query(0.2, 16, jnp.asarray(xyz), jnp.asarray(new_xyz)))
    full = ball_query(0.2, 16, torch.from_numpy(xyz), torch.from_numpy(new_xyz)).numpy()
    np.testing.assert_array_equal(full, want)
