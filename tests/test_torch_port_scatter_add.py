"""The inverse-index kernels' Python side, on the CPU: the scatter-add's
order, the form of the three kernels, and the windowed scatter-mean's claim
ranges.

- ``scatter_add_plain`` against ``mpa_tpu``'s ``scatter_add_rmw`` (its Pallas
  kernel in interpret mode, as ``tests/test_pallas_kernels.py`` runs it) and
  against a numpy loop that adds in ascending e, bit for bit
  (``np.array_equal``): ball-query indices (a short ball repeats its first
  hit, so many edges land on one row), targets outside ``[0, N)`` and
  negative ones, W = 3, 10 and 64. ``scatter_add_rows_kernel`` adds in that
  order and is held bit for bit to ``scatter_add_plain`` on the CPU by the
  card tests, so on these inputs the chain kernel = plain = ``mpa_tpu``
  holds exactly.
- ``scatter_add_form``: four channels a lane where W % 4 == 0 from a
  16-byte boundary, two at other even widths (repsurf's W = 10) from an
  8-byte one, else one; the slots a block halved by
  ``scatter_mean_form``'s rule, then further while a block's rows stay
  large (repsurf's grouped features).
- ``windowed_scatter_mean_form``: ``scatter_mean_form``'s, down to 8
  slots (not 32) while the launch is short of blocks.
- ``ops/window.py::claim_rows``, the Python twin of
  ``kernels/csrc/window.cuh::claim_rows``: the rows whose windows contain a
  slot are exactly its range, and at several ``make_window_spec`` shapes
  every claim of every slot of a block of ``windowed_scatter_mean_kernel``
  (in-window indices from ``windowed_knn_plain``) lies in the block's
  ``block_claim_rows``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)
from test_torch_port_cuda import _morton_pair  # noqa: E402

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from mpa_tpu.ops.pallas.gather_pallas import scatter_add_rmw  # noqa: E402
from mpa_tpu_torch.ops.ball_query import ball_query  # noqa: E402
from mpa_tpu_torch.ops.gather import (  # noqa: E402
    FILL_BLOCKS, MIN_SLOTS, ROW_BYTES, scatter_add_form, scatter_add_plain,
)
from mpa_tpu_torch.ops.scatter import scatter_mean_form  # noqa: E402
from mpa_tpu_torch.ops.window import (  # noqa: E402
    block_claim_rows, claim_rows, make_window_spec, windowed_knn_plain, windowed_scatter_mean_form,
)


def ball_edges(B, N, S, nsample, radius, seed):
    """``[B, S*nsample]`` int32 edge targets of a ball query over a random
    cloud of N points (a centre with fewer hits repeats its first), and
    ``[B, N, 3]`` points."""
    rng = np.random.default_rng(seed)
    xyz = (0.3 * rng.standard_normal((B, N, 3))).astype(np.float32)
    centres = xyz[:, rng.permutation(N)[:S]]
    idx = ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(centres))
    return idx.reshape(B, S * nsample).to(torch.int32).numpy()


def sequential_scatter_add(grads, idx, N):
    """``out[b, idx[b, e]] += grads[b, e]`` in float32, one edge at a time in
    ascending e; targets outside ``[0, N)`` dropped."""
    B, E, W = grads.shape
    out = np.zeros((B, N, W), np.float32)
    for b in range(B):
        for e in range(E):
            t = idx[b, e]
            if 0 <= t < N:
                out[b, t] = out[b, t] + grads[b, e]
    return out


# (W, N, S, nsample, radius): the repsurf stages' balls at W = 3, 10 and 64.
SCATTER_ADD_CPU_CASES = [(10, 128, 64, 24, 0.4), (3, 256, 64, 24, 0.2), (64, 128, 32, 24, 0.4),
                         (10, 512, 128, 24, 0.05)]


@pytest.mark.parametrize("W,N,S,nsample,radius", SCATTER_ADD_CPU_CASES)
def test_scatter_add_plain_matches_scatter_add_rmw_bit_for_bit(W, N, S, nsample, radius):
    B = 2
    idx = ball_edges(B, N, S, nsample, radius, seed=W + N)
    counts = np.bincount(idx[0], minlength=N)
    assert counts.max() > nsample // 2  # short balls: a first hit repeated
    idx[:, 5::37], idx[:, 11::41] = N + 3, -2  # dropped targets
    rng = np.random.default_rng(N)
    grads = rng.standard_normal((B, idx.shape[1], W)).astype(np.float32)
    got = scatter_add_plain(torch.from_numpy(grads), torch.from_numpy(idx), N).numpy()
    assert np.array_equal(got, sequential_scatter_add(grads, idx, N))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_add_rmw(jnp.asarray(grads), jnp.asarray(idx), N))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("B,E,N,W,form", [
    (64, 512, 1024, 10, (128, 2)),  # repsurf sa1's new normals (FPS targets)
    (64, 12288, 1024, 10, (128, 2)),  # repsurf sa1's grouped normals (24 a centre)
    (64, 3072, 512, 256, (16, 4)),  # repsurf sa2's grouped features: 6 KB of rows a slot
    (64, 768, 128, 512, (8, 4)),  # repsurf sa3's grouped features
    (2, 8192, 16384, 64, (64, 4)),  # semseg's la1 (FPS targets)
    (300, 8, 256, 8, (256, 4)),
    (1, 100, 100, 3, (32, 1)),
    (2, 50, 0, 8, (32, 4)),  # no rows
])
def test_scatter_add_form(B, E, N, W, form):
    grads = torch.zeros((B, E, W))
    assert scatter_add_form(grads, N) == form
    # scatter_mean_form's rule (256 halved while the launch has fewer than
    # FILL_BLOCKS blocks, never below 32), then halved down to 8 while half
    # the slots bring ROW_BYTES of rows on average.
    slots, vec = scatter_mean_form(grads, N)
    assert slots == next(s for s in (256, 128, 64, 32)
                         if s == MIN_SLOTS or B * -(-N // s) >= FILL_BLOCKS)
    while slots > 8 and N > 0 and slots // 2 * E * W * 4 >= ROW_BYTES * N:
        slots //= 2
    if vec == 1 and W % 2 == 0:  # two channels a lane for even widths
        vec = 2
    assert (slots, vec) == form


def test_scatter_add_form_on_misaligned_views():
    """Four channels a lane only from a 16-byte boundary, two from an 8-byte
    one, else one."""
    flat = torch.zeros(4 + 2 * 8 * 64)
    for offset, vec in ((1, 1), (2, 2), (4, 4)):
        view = flat[offset:offset + 2 * 8 * 64].view(2, 8, 64)
        assert scatter_add_form(view, 100)[1] == vec


@pytest.mark.parametrize("B,N,C,form", [
    (2, 16384, 64, (64, 4)),  # semseg's largest upsample: as scatter_mean_form's
    (2, 4096, 64, (16, 4)),  # short of blocks: down to 8 slots, not 32
    (2, 2048, 128, (8, 4)),
    (16, 8192, 64, (256, 4)),
    (1, 64, 37, (8, 1)),
])
def test_windowed_scatter_mean_form(B, N, C, form):
    feats = torch.zeros((B, 8, C))
    assert windowed_scatter_mean_form(feats, N) == form
    slots, vec = scatter_mean_form(feats, N)
    assert vec == form[1] and (form[0] == slots or (slots == MIN_SLOTS and form[0] < slots))


# (S, N, sq): make_window_spec shapes from the semseg ladder at 16384 and
# 4096 points, short chunks (sq = 8, 32) and two chunks.
CLAIM_SPECS = [(8192, 16384, 128), (1024, 2048, 128), (2048, 8192, 128), (512, 4096, 32),
               (256, 512, 8), (64, 128, 32), (4096, 4096, 128)]


@pytest.mark.parametrize("S,N,sq", CLAIM_SPECS)
def test_claim_rows_are_the_rows_whose_windows_hold_the_slot(S, N, sq):
    spec = make_window_spec(S, N, sq)
    win0 = spec.window_start().numpy()
    for n in range(0, N, max(1, spec.bn // 4)):
        rows = np.flatnonzero((win0 <= n) & (n < win0 + spec.window))
        lo, hi = claim_rows(spec, n)
        assert rows.tolist() == list(range(lo, hi)), (n, lo, hi)
        assert hi - lo <= 4 * spec.sq


@pytest.mark.parametrize("S,N,sq", CLAIM_SPECS)
def test_block_claim_rows_hold_every_claim_of_the_block(S, N, sq):
    """Every (s, k) whose index names a slot of a block lies in the block's
    row range, for each slot count the form can pick."""
    spec = make_window_spec(S, N, sq)
    fine, coarse = _morton_pair(S + N, 2, S, N, 3, "cpu", dup=True)
    _, idx = windowed_knn_plain(8, fine, coarse, spec)
    s = np.broadcast_to(np.arange(S)[None, :, None], idx.shape).reshape(-1)
    n = idx.numpy().reshape(-1)
    for slots in (8, 16, 32, 64, 128, 256):
        block = n // slots
        ranges = np.array([block_claim_rows(spec, n0, slots) for n0 in range(0, N, slots)])
        assert (ranges[block, 0] <= s).all() and (s < ranges[block, 1]).all()
        if slots <= spec.bn:  # a block within one base block: one pass at sq = 128, K = 8
            assert (ranges[:, 1] - ranges[:, 0]).max() <= 4 * spec.sq
