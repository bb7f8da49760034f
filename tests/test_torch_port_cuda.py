"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, at shapes around the model's, including
the tie cases; the backward kernels and the kNN distance gradient against
the plain versions and torch autograd; one train step on the card against
the CPU; the scatter-mean kernel and its backward; the part segmenter and its
train step against the CPU; the four Morton-window kernels at the
``markov_semseg`` window shapes and at ragged ones, and the semantic
segmenter and its train step against the CPU; the windowed attention
backward at K = 8, 16 and 32 with and without shifts, on in-window
indices, indices anywhere and forced ties; the ball query kernel at the
``repsurf_ssg_2x`` shapes and at ragged ones, the RepSurf classifier and its
train step against the CPU, and ``fps_kernel`` in each form ``fps_form``
picks (one block, each cluster size, the sliced form for any C), each
reached by the shape that picks it, with per-cloud starts,
repeated and all-coincident points and npoint = N, on
``markov_partseg_fp``'s feature clouds and over 16384 points, through the
semantic segmenter's ``window`` mode too; and each form of the windowed
kNN (``windowed_knn_form``) and of the attention forward
(``attention_fwd_form``), exact and windowed, and of the scatter-mean
(``scatter_mean_form``: 32, 128 or 256 slots a block, one or four channels
a lane, passes of 4096 indices), reached the same way, on the hard inputs
(for the scatter-mean: slots with no claim and with more than 32, a slot
named twice by one coarse point, indices outside [0, N), N not a multiple
of a block's slots, S*K = 131072, B = 1, C = 1 to 512, a misaligned view).
Every test here needs a CUDA
card (the kernels have no CPU mode) and skips, through the ``dev`` fixture,
without one.

Tolerances: the attention backward adds with ``atomicAdd``, in an order
that changes from run to run, so its sums are held to a relative tolerance
of 1e-4 (its node gradients also subtract near-equal terms) with an
absolute floor at 1e-5 of the largest entry. The scatter-add adds each
target's edges in ascending order, as the plain version does on the CPU:
it is held bit for bit to that (and within 1e-5 to the plain version on
the card, whose ``index_add_`` is atomic), at the four random shapes, at
``repsurf_ssg_2x``'s eight scatter-adds of a train step on ball-query and
FPS targets, with a target of more than 4096 edges, E = 0, N = 0, each
channel form (one, two and four a lane) and misaligned views. The kNN cases add identical points, distances that fall
as the index rises, an integer grid, the umbrella's k = 9 and part-seg's
largest launch, all held bit for bit; the attention-backward cases a hot
node, unnamed nodes, a node named twice by one query, several neighbours
tied for the maximum and part-seg's la0 shape. The attention cases plant an eps-floored query, whose
neighbours' dE is about 1e20; those entries and the rest are compared apart,
each with the floor of its own largest entry. The train step is held to
``chip_smoke.py``'s limits, on the same inputs. The scatter-mean kernel adds
the claiming rows in a fixed order, the order of a sequential ``index_add_``:
it is held bit for bit against the plain version run on the CPU, and within
1e-5 against the plain version on the card, whose ``index_add_`` is
atomic. The windowed kNN and both attention forwards do the plain versions'
arithmetic in the same order and are held bit for bit; the
windowed attention backward adds with atomics (shared, then global) and is
held as the exact one; the windowed scatter-mean as the exact one, also
where a block's 256 slots span two base blocks and where a block's claim
range takes two passes. The ball
query's sentinel stage does the plain version's distance arithmetic and is
held bit for bit: at the repsurf stages, on ``hit_cloud``'s centres of 0,
1, exactly nsample and more hits (N not a multiple of 32, S not a multiple
of a block's or a warp's centres, C = 3, 6 and 256, N = 16384, several
staged tiles), at r2 on, just below and just above a pair's distance, and
on NaN rows and centres. The gather is held bit for bit in each form
``gather_form`` picks (float4, float2 and scalar columns, one or two a
thread) at W = 1 to 512, E = 1, B = 1 and 64 and views 4, 8 and 12 bytes
off, and its entry refuses the forms it does not take.

Run on a machine with an H100:
    python -m pytest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mpa_tpu_torch import kernels
from mpa_tpu_torch.ops import index_points, knn, transition_attention
from mpa_tpu_torch.ops.attention import (
    attention_bwd_cuda,
    attention_bwd_plain,
    attention_cuda,
    attention_fwd_form,
    attention_plain,
)
from mpa_tpu_torch.ops.ball_query import (
    ball_query,
    ball_query_cuda,
    ball_query_form,
    ball_query_plain,
    radius_squared,
)
from mpa_tpu_torch.ops.fps import fps_chain_cuda, fps_cuda, fps_form, fps_plain
from mpa_tpu_torch.ops.gather import (
    gather_cuda, gather_form, gather_plain, scatter_add_cuda, scatter_add_form, scatter_add_plain,
)
from mpa_tpu_torch.ops.knn import knn_cuda, knn_plain
from mpa_tpu_torch.ops.scatter import (
    scatter_mean_cuda, scatter_mean_form, scatter_mean_plain, scatter_mean_upsample,
)
from mpa_tpu_torch.ops.morton import morton_sort
from mpa_tpu_torch.ops.pairwise import square_distance
from mpa_tpu_torch.ops.window import (
    block_claim_rows,
    make_window_spec,
    windowed_attention_bwd_cuda,
    windowed_attention_cuda,
    windowed_knn_cuda,
    windowed_knn_form,
    windowed_knn_plain,
    windowed_knn_with_spec,
    windowed_scatter_mean,
    windowed_scatter_mean_cuda,
    windowed_scatter_mean_form,
)
from mpa_tpu_torch.serve import load_classifier, load_segmenter


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cloud(seed, shape, dev, dup=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dup:
        x[:, 5::5] = x[:, 4::5][:, : x[:, 5::5].shape[1]]
    return torch.from_numpy(x).to(dev)


def knn_cloud(kind, B, N, S, C, dup, self_query, seed=0):
    """(base, query) numpy clouds for the kNN cases: ``normal`` points (every
    fifth a duplicate with ``dup``); ``identical`` points, every distance 0;
    ``falling``, base points on a line towards the queries, so each new
    index is nearer and beats the threshold (the worst case for a shared
    threshold); ``grid``, points on an integer grid, with many distances
    exactly equal."""
    rng = np.random.default_rng(seed)
    if kind == "identical":
        base = np.full((B, N, C), 0.5, np.float32)
        query = np.full((B, S, C), 0.5, np.float32)
    elif kind == "falling":
        base = np.zeros((B, N, C), np.float32)
        base[..., 0] = (N - np.arange(N, dtype=np.float32)) * np.float32(0.01)
        query = (0.001 * rng.standard_normal((B, S, C))).astype(np.float32)
    elif kind == "grid":
        base = rng.integers(-3, 4, (B, N, C)).astype(np.float32)
        query = rng.integers(-3, 4, (B, S, C)).astype(np.float32)
    else:
        base = rng.standard_normal((B, N, C)).astype(np.float32)
        if dup:
            base[:, 5::5] = base[:, 4::5][:, : base[:, 5::5].shape[1]]
        query = np.random.default_rng(seed + 1).standard_normal((B, S, C)).astype(np.float32)
    return base, base if self_query else query


# (k, N, S, C, dup, self_query, cloud, B)
KNN_CASES = [
    (8, 1024, 1024, 3, True, True, "normal", 2),
    (8, 1024, 512, 64, False, False, "normal", 2),
    (8, 64, 32, 256, False, False, "normal", 2),
    (16, 300, 77, 5, True, False, "normal", 2),
    (64, 200, 40, 600, False, False, "normal", 2),
    (8, 100, 50, 1024, False, False, "normal", 2),
    (8, 300, 70, 3, False, False, "identical", 2),
    (8, 130, 130, 64, False, True, "identical", 2),
    (8, 2048, 64, 3, False, False, "falling", 2),
    (16, 1000, 100, 64, False, False, "falling", 2),
    (16, 1024, 512, 3, False, False, "grid", 2),
    (8, 700, 300, 8, False, True, "grid", 2),
    (9, 1024, 1024, 3, False, True, "normal", 64),  # the umbrella's self-kNN
    (64, 1000, 1, 600, False, False, "normal", 2),  # N ragged to every tile, S = 1
    (8, 2048, 2048, 64, False, True, "normal", 32),  # part-seg's largest launch
    # The streaming form's scalar loads (C not a multiple of 4): C = 3 over a
    # cloud too large to stay resident, C = 9 (1 x 4 tiles, query staged) and
    # C = 130 (query streamed, a ragged last chunk), N and S ragged.
    (8, 8192, 1000, 3, True, False, "normal", 2),
    (16, 7000, 500, 3, False, False, "grid", 2),
    (16, 777, 333, 9, False, False, "normal", 2),
    (8, 1001, 300, 130, False, False, "normal", 2),
]


@pytest.mark.parametrize("k,N,S,C,dup,self_query,cloud,B", KNN_CASES)
def test_knn_kernel_matches_plain(dev, k, N, S, C, dup, self_query, cloud, B):
    base, query = knn_cloud(cloud, B, N, S, C, dup, self_query)
    base = torch.from_numpy(base).to(dev)
    query = base if self_query else torch.from_numpy(query).to(dev)
    gd, gi = knn_cuda(k, base, query)
    wd, wi = knn_plain(k, base, query)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert torch.equal(gd, wd)
    if cloud == "identical":
        assert not gd.any()
        assert torch.equal(gi, torch.arange(k, dtype=torch.int32, device=dev).expand_as(gi))


@pytest.mark.parametrize("C", [3, 64])
def test_knn_kernel_misaligned_view(dev, C):
    # A contiguous view 4 bytes into its storage: the kernel's float4 loads
    # need 16-byte rows, so knn_cuda refuses it and knn copies it first.
    base, query = knn_cloud("normal", 2, 500, 100, C, False, False)
    flat = torch.from_numpy(np.concatenate([[0.0], base.ravel()]).astype(np.float32)).to(dev)
    view = flat[1:].view(base.shape)
    query = torch.from_numpy(query).to(dev)
    with pytest.raises(ValueError, match="16-byte"):
        knn_cuda(8, view, query)
    gd, gi = knn(8, view, query)
    wd, wi = knn_plain(8, view, query)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("N,npoint,C,dup", [(1024, 512, 3, False), (2048, 1024, 3, True),
                                              (100, 37, 3, False), (512, 64, 6, True),
                                              (4096, 2048, 3, False)])  # 48 KB of cloud
def test_fps_kernel_matches_plain(dev, N, npoint, C, dup):
    pts = _cloud(2, (3, N, C), dev, dup)
    got = fps_cuda(pts, npoint)
    want = fps_plain(pts, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fps_kernel_all_coincident(dev):
    pts = torch.zeros((2, 64, 3), device=dev)
    assert torch.equal(fps_cuda(pts, 8), fps_plain(pts, 8))


@pytest.mark.parametrize("N,E,W", [(1024, 512, 3), (512, 256, 64), (64, 32, 5), (300, 900, 256)])
def test_gather_kernel_matches_plain(dev, N, E, W):
    pts = _cloud(3, (2, N, W), dev)
    idx = torch.randint(0, N, (2, E), generator=torch.Generator().manual_seed(0)).to(torch.int32).to(dev)
    assert torch.equal(gather_cuda(pts, idx), gather_plain(pts, idx))


def offset_cloud(shape, offset, seed=3):
    """A contiguous float32 ``[B,N,W]`` CUDA view that starts ``offset``
    floats into its buffer (misaligned for float4 unless offset % 4 == 0)."""
    n = int(np.prod(shape))
    buf = torch.from_numpy(np.random.default_rng(seed).standard_normal(n + offset)
                           .astype(np.float32)).cuda()
    return buf[offset:].view(shape)


# (B, N, E, W, offset, form): W = 1, 3, 10, 64, 256 and 512, E = 1, B = 1
# and 64, views 4, 8 and 12 bytes off; form is gather_form's (vec, elems).
GATHER_CASES = [
    (64, 1024, 512, 3, 0, (1, 1)),  # new_xyz at cls's first step
    (64, 1024, 512, 64, 0, (4, 1)),  # center_feat at cls's first step
    (64, 64, 32, 256, 0, (4, 1)),  # cls's last step
    (64, 128, 768, 512, 0, (4, 2)),  # repsurf sa3's grouped features
    (64, 1024, 12288, 10, 0, (2, 2)),  # repsurf sa1's grouped normals
    (64, 64, 1, 1, 0, (1, 1)),  # E = 1
    (1, 100, 1, 3, 0, (1, 1)),  # B = 1, E = 1
    (1, 64, 1, 256, 0, (4, 1)),
    (1, 300, 900, 10, 1, (1, 1)),  # 4 bytes off: scalar columns
    (2, 300, 700, 256, 2, (2, 1)),  # 8 bytes off: float2
    (3, 77, 130, 64, 3, (1, 1)),
    (2, 90, 45, 6, 2, (2, 1)),
    (2, 90, 4000, 4, 0, (4, 1)),
    (2, 90, 4000, 4, 1, (1, 1)),
    (64, 2048, 16384, 3, 0, (1, 2)),
    (32, 2048, 8192, 64, 0, (4, 2)),  # part-seg's largest scatter-mean backward
    (2, 16384, 8192, 64, 0, (4, 1)),  # semseg's first center_feat
]


@pytest.mark.parametrize("B,N,E,W,offset,form", GATHER_CASES)
def test_gather_kernel_forms_match_plain(dev, B, N, E, W, offset, form):
    pts = offset_cloud((B, N, W), offset)
    idx = torch.randint(0, N, (B, E), generator=torch.Generator().manual_seed(E), dtype=torch.int32)
    idx = idx.to(dev)
    assert gather_form(pts, B * E) == form
    kernels.reset_launch_counts()
    got = gather_cuda(pts, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_rows_kernel"] == 1
    assert torch.equal(got, gather_plain(pts, idx))
    assert torch.equal(got.cpu(), gather_plain(pts.cpu(), idx.cpu()))


def test_gather_kernel_refuses_forms_gather_form_does_not_pick(dev):
    """The entry refuses a vec that does not divide W or is misaligned and
    elems other than 1 and 2, and launches nothing for E = 0; both
    columns-a-thread counts copy the same rows."""
    from mpa_tpu_torch.kernels import build

    lib = build.load()
    pts = offset_cloud((2, 64, 12), 1)
    idx = torch.randint(0, 64, (2, 300), generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32).to(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(vec, elems, E=300):
        out = torch.zeros((2, E, 12), device=dev)
        err = lib.mpa_gather_rows(pts.data_ptr(), idx.data_ptr(), out.data_ptr(), 2, 64, E, 12,
                                  vec, elems, stream)
        return err, out

    for vec, elems in [(4, 1), (2, 1), (3, 1), (1, 0), (1, 3), (1, 4)]:
        assert call(vec, elems)[0] != 0, (vec, elems)
    assert call(1, 1, E=0)[0] == 0
    want = gather_plain(pts, idx)
    for elems in (1, 2):
        err, out = call(1, elems)
        torch.cuda.synchronize()
        assert err == 0 and torch.equal(out, want)


@pytest.mark.parametrize("n_branches,with_shift,N,S,K,c", [
    (1, True, 1024, 1024, 8, 64),
    (1, False, 64, 32, 8, 512),
    (2, True, 300, 100, 16, 24),
    (2, False, 50, 20, 5, 7),
])
def test_attention_kernel_matches_plain(dev, n_branches, with_shift, N, S, K, c):
    g = torch.Generator().manual_seed(1)
    packed = torch.randn((2, N, n_branches * 2 * c), generator=g)
    for r in range(n_branches):
        packed[..., 2 * r * c:(2 * r + 1) * c] = packed[..., 2 * r * c:(2 * r + 1) * c].exp()
    idx = torch.randint(0, N, (2, S, K), generator=g, dtype=torch.int32)
    shifts = torch.randn((2, S, n_branches * c), generator=g) if with_shift else None
    packed, idx = packed.to(dev), idx.to(dev)
    shifts = None if shifts is None else shifts.to(dev)
    got = attention_cuda(packed, idx, shifts, n_branches, c)
    want = attention_plain(packed, idx, shifts, n_branches, c)
    assert torch.equal(got, want)


def _close(got, want, rtol):
    atol = 1e-5 * float(want.abs().max()) + 1e-30
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("N,E,W,oob", [(1024, 512, 64, False), (512, 4096, 3, False),
                                         (64, 1000, 130, True), (4096, 2048, 512, False)])
def test_scatter_add_kernel_matches_plain(dev, N, E, W, oob):
    g = torch.Generator().manual_seed(N)
    grads = torch.randn((2, E, W), generator=g)
    idx = torch.randint(0, N, (2, E), generator=g, dtype=torch.int32)
    if oob:  # dropped targets
        idx[:, ::7] = N + 5
        idx[:, 1::7] = -1
    grads, idx = grads.to(dev), idx.to(dev)
    got = scatter_add_cuda(grads, idx, N)
    want = scatter_add_plain(grads, idx, N)
    _close(got, want, rtol=1e-5)
    # The sequential order of the plain version on the CPU, bit for bit.
    assert torch.equal(got.cpu(), scatter_add_plain(grads.cpu(), idx.cpu(), N))


def _scatter_add_exact(grads, idx, N, form=None):
    """``scatter_add_cuda`` bit for bit equal to ``scatter_add_plain`` on the
    CPU (the sequential order), twice the same, in the form ``form``
    (``scatter_add_form``'s pick asserted) where given."""
    if form is not None:
        assert scatter_add_form(grads, N) == form
    kernels.reset_launch_counts()
    got = scatter_add_cuda(grads, idx, N)
    again = scatter_add_cuda(grads, idx, N)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scatter_add_rows_kernel"] == 2
    want = scatter_add_plain(grads.cpu(), idx.cpu(), N)
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want), f"{int((got.cpu() != want).sum())} places differ"
    assert torch.equal(got, again)
    return want


# (N, S, radius, W, edges, form): repsurf_ssg_2x's scatter-adds of a train
# step at its batch, B = 64: each stage's new normals (FPS targets,
# distinct) and grouped normals (ball query targets, a short ball repeating
# its first hit), and the features grouped at sa2 (W = 256) and sa3
# (W = 512).
REPSURF_SCATTER_ADDS = [
    (1024, 512, 0.1, 10, "fps", (128, 2)), (1024, 512, 0.1, 10, "ball", (128, 2)),
    (512, 128, 0.2, 10, "fps", (64, 2)), (512, 128, 0.2, 10, "ball", (64, 2)),
    (512, 128, 0.2, 256, "ball", (16, 4)),
    (128, 32, 0.4, 10, "fps", (32, 2)), (128, 32, 0.4, 10, "ball", (32, 2)),
    (128, 32, 0.4, 512, "ball", (8, 4)),
]


@pytest.mark.parametrize("N,S,radius,W,edges,form", REPSURF_SCATTER_ADDS)
def test_scatter_add_kernel_repsurf_shapes(dev, N, S, radius, W, edges, form):
    B = 64
    r = np.random.default_rng(N + W)
    xyz = (0.3 * r.standard_normal((B, N, 3))).astype(np.float32)
    perm = r.permutation(N)[:S]
    if edges == "fps":
        idx = torch.from_numpy(np.broadcast_to(perm, (B, S)).astype(np.int32).copy())
    else:
        centres = torch.from_numpy(xyz[:, perm]).contiguous()
        idx = ball_query(radius, 24, torch.from_numpy(xyz), centres).reshape(B, S * 24)
        idx = idx.to(torch.int32)
        assert int(torch.bincount(idx[0], minlength=N).max()) > 12  # a first hit repeated
    grads = torch.from_numpy(r.standard_normal((B, idx.shape[1], W)).astype(np.float32))
    _scatter_add_exact(grads.to(dev), idx.to(dev), N, form)


@pytest.mark.parametrize("case", ["passes", "empty_edges", "no_points", "vec1", "vec2", "vec4",
                                  "misaligned", "misaligned8", "dropped"])
def test_scatter_add_kernel_edge_cases(dev, case):
    """A target with more than 4096 edges (several passes of the index), E =
    0, N = 0, each channel form, views of the gradients 4 and 8 bytes into
    their storage, and every edge dropped."""
    g = torch.Generator().manual_seed(len(case))
    B, E, N, W, form = {
        "passes": (2, 10000, 64, 3, (32, 1)),
        "empty_edges": (2, 0, 100, 8, (32, 4)),
        "no_points": (2, 50, 0, 8, (32, 4)),
        "vec1": (4, 3000, 700, 37, (32, 1)),
        "vec2": (4, 3000, 700, 38, (32, 2)),
        "vec4": (64, 3000, 700, 36, (128, 4)),
        "misaligned": (2, 500, 300, 64, (32, 1)),
        "misaligned8": (2, 500, 300, 64, (32, 2)),
        "dropped": (2, 500, 300, 16, (32, 4)),
    }[case]
    grads = torch.randn((B, E, W), generator=g)
    idx = torch.randint(0, max(N, 1), (B, E), generator=g, dtype=torch.int32)
    if case == "passes":
        idx[:, ::3] = 7  # 3334 edges to row 7 a cloud, in three passes of 4096
        idx[0, :5000] = 7  # 5000 and more to row 7 of cloud 0
    if case == "dropped":
        idx[0] = -1
        idx[1] = N
    grads, idx = grads.to(dev), idx.to(dev)
    if case.startswith("misaligned"):
        pad = 2 if case == "misaligned8" else 1
        flat = torch.cat([torch.zeros(pad, device=dev), grads.reshape(-1)])
        grads = flat[pad:].view(B, E, W)
    want = _scatter_add_exact(grads, idx, N, form)
    if case == "passes":
        assert int((idx[0] == 7).sum()) > 4096
    if case in ("empty_edges", "dropped"):
        assert not want.any()


FLOORED = 4  # the last nodes, E = 0: the neighbours of the eps-floored query


def _close_dpacked(got, want, n_branches, c, rtol):
    """dpacked in two parts, each against its own scale: the E columns of
    the floored nodes (dE = dw V' / 1e-20, about 1e20) and everything else
    (order 1)."""
    floored = torch.zeros_like(want, dtype=torch.bool)
    for r in range(n_branches):
        floored[:, -FLOORED:, 2 * r * c:(2 * r + 1) * c] = True
    assert float(want[floored].abs().max()) > 1e15
    _close(got[floored], want[floored], rtol)
    _close(got[~floored], want[~floored], rtol)


def _attention_inputs(dev, n_branches, with_shift, N, S, K, c, seed=1, B=2):
    g = torch.Generator().manual_seed(seed)
    packed = torch.randn((B, N, n_branches * 2 * c), generator=g)
    for r in range(n_branches):
        e = slice(2 * r * c, (2 * r + 1) * c)
        packed[..., e] = packed[..., e].exp()
        packed[:, -FLOORED:, e] = 0.0  # E = 0 on the last nodes
    packed[:, 1] = packed[:, 0]  # a duplicate node: equal w, a tie
    idx = torch.randint(0, N - FLOORED, (B, S, K), generator=g, dtype=torch.int32)
    idx[:, 0, :2] = torch.tensor([0, 1], dtype=torch.int32)
    idx[:, 1] = N - FLOORED + torch.arange(K, dtype=torch.int32) % FLOORED  # eps-floored query
    idx[:, 2] = 5  # all K neighbours one node: a K-way tie
    shifts = torch.randn((B, S, n_branches * c), generator=g) if with_shift else None
    gctx = torch.randn((B, S, n_branches * c), generator=g)
    return (packed.to(dev), idx.to(dev), None if shifts is None else shifts.to(dev),
            gctx.to(dev))


def attention_case(case, packed, idx):
    """Plant a case's indices into ``_attention_inputs``' (torch, any
    device): ``hot``, node 7 named by every query; ``unnamed``, no query
    names the nodes from N // 2 up to the floored ones; ``twice``, node 9
    named twice by every third query; ``ties``, several neighbours tied for
    the maximum (node 0's duplicate, node 1, twice and three times). Returns
    the unnamed nodes' mask, or None."""
    N = packed.shape[1]
    if case == "hot":
        idx[:, 3:, 0] = 7
    elif case == "unnamed":
        floored_query = idx[:, 1].clone()
        idx.remainder_(N // 2)
        idx[:, 1] = floored_query
        unnamed = torch.zeros(N, dtype=torch.bool)
        unnamed[N // 2:N - FLOORED] = True
        return unnamed
    elif case == "twice":
        idx[:, 3::3, 1] = 9
        idx[:, 3::3, 2] = 9
    elif case == "ties":
        K = idx.shape[2]
        idx[:, 3::2, :min(K, 5)] = torch.tensor([0, 1, 0, 1, 1], dtype=idx.dtype)[:min(K, 5)]
    return None


# (n_branches, with_shift, N, S, K, c, case, B)
ATTENTION_BWD_CASES = [
    (1, True, 1024, 1024, 8, 64, "plain", 2),
    (1, False, 1024, 512, 8, 64, "plain", 2),
    (1, False, 64, 32, 8, 512, "plain", 2),
    (2, True, 300, 100, 16, 24, "plain", 2),
    (2, False, 50, 20, 5, 7, "plain", 2),
    (1, True, 200, 60, 64, 32, "plain", 2),
    (2, True, 512, 512, 8, 32, "hot", 2),
    (1, False, 300, 200, 16, 64, "hot", 2),
    (2, True, 512, 256, 8, 32, "unnamed", 2),
    (1, True, 100, 90, 33, 24, "unnamed", 2),
    (2, True, 256, 256, 8, 32, "twice", 2),
    (2, False, 256, 256, 8, 48, "ties", 2),
    (1, True, 128, 100, 64, 16, "ties", 2),
    (1, True, 2048, 2048, 8, 64, "plain", 32),  # part-seg's la0 shape
]


@pytest.mark.parametrize("n_branches,with_shift,N,S,K,c,case,B", ATTENTION_BWD_CASES)
def test_attention_bwd_kernel_matches_plain(dev, n_branches, with_shift, N, S, K, c, case, B):
    packed, idx, shifts, gctx = _attention_inputs("cpu", n_branches, with_shift, N, S, K, c, B=B)
    unnamed = attention_case(case, packed, idx)
    packed, idx, gctx = packed.to(dev), idx.to(dev), gctx.to(dev)
    shifts = None if shifts is None else shifts.to(dev)
    got_p, got_s = attention_bwd_cuda(packed, idx, shifts, gctx, n_branches, c)
    want_p, want_s = attention_bwd_plain(packed, idx, shifts, gctx, n_branches, c)
    torch.cuda.synchronize()
    assert torch.isfinite(got_p).all()
    _close_dpacked(got_p, want_p, n_branches, c, rtol=1e-4)
    if unnamed is not None:
        assert not got_p[:, unnamed.to(dev)].any()
    if with_shift:
        _close(got_s, want_s, rtol=1e-5)
    else:
        assert got_s is None


# (n_branches, with_shift, N, S, K, c, case, B, channels a thread): every
# case also plants an eps-floored query, a duplicate node and a K-way tie.
ATTENTION_FWD_CASES = [
    (1, True, 1024, 1024, 8, 64, "plain", 2, 4),
    (1, False, 64, 32, 8, 512, "plain", 2, 4),
    (2, True, 300, 100, 16, 24, "plain", 2, 4),
    (2, False, 50, 20, 5, 7, "plain", 2, 1),
    (1, True, 200, 60, 64, 32, "plain", 2, 1),  # K = 64: one channel a thread
    (2, True, 512, 512, 8, 32, "hot", 2, 4),
    (2, True, 300, 100, 16, 7, "hot", 2, 1),
    (2, True, 256, 256, 8, 32, "twice", 2, 4),
    (2, False, 256, 256, 8, 48, "ties", 2, 4),
    (1, True, 100, 90, 5, 7, "ties", 2, 1),
    (1, True, 128, 100, 64, 16, "ties", 2, 1),
    (2, True, 200, 100, 33, 24, "twice", 2, 1),  # K = 33 in the K = 64 body
    (1, True, 2048, 2048, 8, 64, "plain", 32, 4),  # part-seg's la0 shape
    (2, True, 512, 512, 8, 128, "plain", 32, 4),  # part-seg's packed LocalMerge
]


@pytest.mark.parametrize("n_branches,with_shift,N,S,K,c,case,B,vec", ATTENTION_FWD_CASES)
def test_attention_fwd_kernel_forms_match_plain(dev, n_branches, with_shift, N, S, K, c, case,
                                                B, vec):
    """Each of ``attention_fwd_form``'s forms, reached by the shape that
    picks it, bit-equal to the plain version on the hard inputs."""
    packed, idx, shifts, _ = _attention_inputs("cpu", n_branches, with_shift, N, S, K, c, B=B)
    attention_case(case, packed, idx)
    packed, idx = packed.to(dev), idx.to(dev)
    shifts = None if shifts is None else shifts.to(dev)
    assert attention_fwd_form(packed, shifts, K, c) == vec
    got = attention_cuda(packed, idx, shifts, n_branches, c)
    want = attention_plain(packed, idx, shifts, n_branches, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} places differ"
    assert torch.isfinite(got).all()  # the eps-floored query's attn is -1, not inf


@pytest.mark.parametrize("misaligned", ["packed", "shifts"])
def test_attention_fwd_kernel_misaligned_view(dev, misaligned):
    """A contiguous view 4 bytes into its storage takes one channel a thread
    (C % 4 == 0 notwithstanding) and still equals the plain version."""
    packed, idx, shifts, _ = _attention_inputs("cpu", 2, True, 300, 200, 8, 32)

    def shifted(t):
        flat = torch.cat([torch.zeros(1), t.reshape(-1)]).to(dev)
        return flat[1:].view(t.shape)

    packed = shifted(packed) if misaligned == "packed" else packed.to(dev)
    shifts = shifted(shifts) if misaligned == "shifts" else shifts.to(dev)
    idx = idx.to(dev)
    assert attention_fwd_form(packed, shifts, 8, 32) == 1
    got = attention_cuda(packed, idx, shifts, 2, 32)
    assert torch.equal(got, attention_plain(packed, idx, shifts, 2, 32))


def test_autograd_functions_on_cuda_match_plain(dev):
    """index_points, transition_attention and the kNN distances on CUDA
    tensors: forward through their kernels, backward through theirs, against
    torch autograd of the plain versions on the same CUDA tensors."""
    packed, idx, shifts, gctx = _attention_inputs(dev, 1, True, 256, 128, 8, 32)
    base = _cloud(5, (2, 256, 16), dev, dup=True)
    query = _cloud(6, (2, 64, 16), dev)
    fidx = torch.randint(0, 256, (2, 64, 4), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32).to(dev)

    def run(attn, gather, knn_fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in (packed, shifts, base, query)]
        p, s, b, q = leaves
        dist, _ = knn_fn(8, b, q)
        loss = (attn(p, idx, s, 1, 32) * gctx).sum() + (gather(b, fidx) ** 2).sum() \
            + (dist * torch.linspace(0.5, 1.5, 8, device=dev)).sum()
        return torch.autograd.grad(loss, leaves)

    kernels.reset_launch_counts()
    got = run(transition_attention, index_points, knn)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["transition_attention_bwd_kernel"] == 1
    # the gather's backward, and the kNN backward into the base points
    assert kernels.LAUNCHES["scatter_add_rows_kernel"] == 2
    want = run(attention_plain, gather_plain, knn_plain)
    _close_dpacked(got[0], want[0], 1, 32, rtol=1e-4)
    for a, b in zip(got[1:], want[1:]):
        _close(a, b, rtol=1e-5)


def test_train_step_on_cuda_matches_cpu_and_counts_launches(dev):
    """One adam-l2 step at full width (B = 16 x 1024, dropout 0) on the card
    and on the CPU from the same weights, through ``chip_smoke.train_parity``:
    loss within 1e-4, every gradient within the path's ``grad_limit`` units
    of ``chip_smoke.grad_error_units``, the updated BatchNorm statistics
    within 1e-4 relative; and the card step's launch counts."""
    parity = chip_smoke.train_parity("cls")
    assert parity["launches"] == {
        "knn_kernel": 11, "fps_kernel": 5, "gather_rows_kernel": 10,
        "transition_attention_fwd_kernel": 11, "scatter_add_rows_kernel": 5,
        "transition_attention_bwd_kernel": 11,
    }
    assert parity["loss_diff"] <= 1e-4
    name, units = parity["grad_units"][0]
    assert units <= chip_smoke.PATHS["cls"]["grad_limit"], f"grad {name}: {units:.3f} units"
    name, err = parity["stat"]
    assert err < 1e-4, f"{name}: relative error {err:.3e}"


def test_classifier_on_cuda_matches_cpu_and_counts_launches(dev):
    x = np.random.default_rng(4).standard_normal((4, 1024, 3)).astype(np.float32)
    gpu = load_classifier(seed=0)
    cpu = load_classifier(device="cpu", seed=0)
    kernels.reset_launch_counts()
    got = gpu(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"knn_kernel": 11, "fps_kernel": 5, "gather_rows_kernel": 10,
                                "transition_attention_fwd_kernel": 11,
                                "scatter_add_rows_kernel": 0,
                                "transition_attention_bwd_kernel": 0,
                                "scatter_mean_kernel": 0, "windowed_knn_kernel": 0,
                                "windowed_attention_fwd_kernel": 0,
                                "windowed_attention_bwd_kernel": 0,
                                "windowed_scatter_mean_kernel": 0, "ball_query_kernel": 0}
    torch.testing.assert_close(got.cpu(), cpu(x), rtol=0, atol=1e-3)


# -- the scatter-mean kernel ------------------------------------------------------


def _scatter_case(name, dev):
    """``(features [B,S,C], idx [B,S,K], N)`` on ``dev`` for a named case."""
    B, S, K, N, C = {
        "decoder": (4, 1024, 8, 2048, 64),  # the largest part-seg shape, B cut
        "fuse_far": (4, 128, 8, 2048, 64),  # most slots unclaimed
        "wide": (2, 128, 8, 256, 128),
        "odd": (3, 77, 5, 301, 37),
        "k1": (2, 100, 1, 64, 16),
        "c1": (2, 90, 8, 200, 1),
        "c256": (2, 64, 8, 128, 256),
        "c300": (1, 50, 3, 70, 300),  # more than one pass over the channels
        "one_slot": (2, 200, 8, 50, 32),
        "tiles": (1, 3000, 8, 500, 8),  # S*K spans three staged index tiles
    }[name]
    g = torch.Generator().manual_seed(len(name) + S)
    feats = torch.randn((B, S, C), generator=g)
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    if name == "one_slot":
        idx[:] = 7  # every coarse point claims slot 7, K times over
    if name == "odd":
        idx[:, 3, :] = 11  # one coarse point names a slot K times
        idx[:, 5, 0] = N + 2  # outside [0, N): claims nothing
        idx[:, 6, 1] = -1
    return feats.to(dev), idx.to(dev), N


SCATTER_CASES = ["decoder", "fuse_far", "wide", "odd", "k1", "c1", "c256", "c300", "one_slot",
                 "tiles"]


def scatter_mean_case(case, B, S, K, N, C, seed=0):
    """numpy features ``[B,S,C]`` f32 and indices ``[B,S,K]`` int32 into N
    slots: ``plain``, indices drawn in [0, N); ``zero_and_many``, slot N - 1
    never claimed and slot 7 claimed by every fifth coarse point (more than
    32 claims once S > 160); ``twice``, coarse point 3 naming slot 11 twice;
    ``outside``, indices N + 2, -1, 2^31 - 1 and -2^31, which claim no
    slot."""
    rng = np.random.default_rng(seed + S + N + C)
    feats = rng.standard_normal((B, S, C)).astype(np.float32)
    idx = rng.integers(0, N - (case == "zero_and_many"), (B, S, K)).astype(np.int32)
    if case == "zero_and_many":
        idx[:, ::5, 0] = 7
    elif case == "twice":
        idx[:, 3] = (11 + np.maximum(np.arange(K) - 1, 0)) % N
    elif case == "outside":
        idx[:, 5, 0], idx[:, 6, K - 1] = N + 2, -1
        idx[:, 7, 0], idx[:, 8, K - 1] = 2 ** 31 - 1, -2 ** 31
    return feats, idx


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_mean_kernel_matches_plain(dev, case):
    feats, idx, N = _scatter_case(case, dev)
    got, got_count = scatter_mean_cuda(feats, idx, N)
    again, _ = scatter_mean_cuda(feats, idx, N)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # a fixed order of the sum: no run-to-run difference
    want, want_count = scatter_mean_plain(feats, idx, N)
    assert torch.equal(got_count, want_count)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    cpu, cpu_count = scatter_mean_plain(feats.cpu(), idx.cpu(), N)
    assert torch.equal(got_count.cpu(), cpu_count)
    assert torch.equal(got.cpu(), cpu)  # the sequential order, bit for bit
    if case in ("fuse_far", "odd"):
        assert (got_count == 0).any() and (got[got_count == 0] == 0).all()
    if case == "one_slot":
        assert float(got_count[0, 7]) == 200 * 8 and float(got_count.sum()) == 2 * 200 * 8


# (case, B, S, K, N, C, (slots a block, channels a lane)): each form of
# scatter_mean_form, on the hard inputs of scatter_mean_case.
SCATTER_MEAN_FORM_CASES = [
    ("zero_and_many", 2, 512, 8, 1000, 64, (32, 4)),  # N not a multiple of 32
    ("twice", 32, 1024, 8, 2048, 64, (128, 4)),  # part-seg's largest decoder upsample
    ("outside", 2, 300, 8, 500, 31, (32, 1)),
    ("plain", 64, 100, 8, 1100, 8, (256, 4)),  # N not a multiple of 256
    ("plain", 1, 200, 8, 300, 1, (32, 1)),
    ("plain", 2, 100, 8, 260, 33, (32, 1)),
    ("plain", 2, 50, 8, 100, 130, (32, 1)),
    ("zero_and_many", 2, 256, 8, 100, 512, (32, 4)),
    ("zero_and_many", 1, 16384, 8, 4096, 16, (32, 4)),  # S*K = 131072: 32 passes
]


@pytest.mark.parametrize("case,B,S,K,N,C,form", SCATTER_MEAN_FORM_CASES)
def test_scatter_mean_kernel_forms_match_plain(dev, case, B, S, K, N, C, form):
    """Each form ``scatter_mean_form`` picks, reached by the shape that
    picks it: the count exactly and the mean bit for bit equal to the plain
    version on the CPU (the sequential order), and two launches equal."""
    feats, idx = (torch.from_numpy(a) for a in scatter_mean_case(case, B, S, K, N, C))
    f, i = feats.to(dev), idx.to(dev)
    assert scatter_mean_form(f, N) == form
    got, got_count = scatter_mean_cuda(f, i, N)
    again, again_count = scatter_mean_cuda(f, i, N)
    torch.cuda.synchronize()
    want, want_count = scatter_mean_plain(feats, idx, N)
    assert torch.equal(got_count.cpu(), want_count)
    assert torch.equal(got.cpu(), want), f"{int((got.cpu() != want).sum())} places differ"
    assert torch.equal(got, again) and torch.equal(got_count, again_count)
    if case == "zero_and_many":
        assert float(want_count.max()) > 32 and bool((want_count == 0).any())


def test_scatter_mean_kernel_misaligned_view(dev):
    """A contiguous view 4 bytes into its storage takes one channel a lane
    (C % 4 == 0 notwithstanding) and still equals the plain version."""
    feats, idx = (torch.from_numpy(a) for a in scatter_mean_case("plain", 2, 100, 8, 200, 64))
    flat = torch.cat([torch.zeros(1), feats.reshape(-1)]).to(dev)
    view = flat[1:].view(feats.shape)
    assert scatter_mean_form(view, 200) == (32, 1)
    got, got_count = scatter_mean_cuda(view, idx.to(dev), 200)
    want, want_count = scatter_mean_plain(feats, idx, 200)
    assert torch.equal(got_count.cpu(), want_count) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", ["decoder", "fuse_far", "odd", "k1", "c1", "c256", "one_slot"])
def test_scatter_mean_backward_matches_autograd_of_plain(dev, case):
    feats, idx, N = _scatter_case(case, dev)
    idx = idx.clamp(0, N - 1)  # the backward gathers: indices in range
    g = torch.randn((feats.shape[0], N, feats.shape[2]),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    kernels.reset_launch_counts()
    f = feats.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(scatter_mean_upsample(f, idx, N), f, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scatter_mean_kernel"] == 1
    assert kernels.LAUNCHES["gather_rows_kernel"] == 1
    f = feats.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(scatter_mean_plain(f, idx, N)[0], f, g)
    # One divide and a sum over K per entry on both sides, in another order.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_segmenter_on_cuda_matches_cpu_and_counts_launches(dev):
    """Launch counts of one request at full width, and the card against the
    CPU at B = 4 through ``chip_smoke.segmenter_parity``, held to
    ``chip_smoke.SEG_LIMITS``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2048, 3)).astype(np.float32)
    kernels.reset_launch_counts()
    got = load_segmenter(seed=0)(x, rng.integers(0, 16, 2))
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == chip_smoke.PARTSEG_FORWARD
    assert tuple(got.shape) == (2, 2048, 50) and torch.isfinite(got).all()
    report = chip_smoke.segmenter_parity()
    assert report["median_abs"] <= chip_smoke.SEG_LIMITS["median_abs"], report
    assert report["argmax_agreement"] >= chip_smoke.SEG_LIMITS["argmax_agreement"], report


def test_partseg_train_step_on_cuda_matches_cpu_and_counts_launches(dev):
    """One SGD step of the ``shapenetpart`` preset (B = 4 x 2048, dropout 0)
    on the card and on the CPU from the same weights, through
    ``chip_smoke.train_parity``, held to ``chip_smoke.py``'s limits."""
    parity = chip_smoke.train_parity("partseg")
    assert parity["launches"] == chip_smoke.PATHS["partseg"]["per_train_step"]
    assert parity["loss_diff"] <= 1e-4, parity["loss_diff"]
    name, units = parity["grad_units"][0]
    assert units <= chip_smoke.PATHS["partseg"]["grad_limit"], f"grad {name}: {units:.3f} units"
    name, err = parity["stat"]
    assert err < 1e-4, f"{name}: relative error {err:.3e}"


# -- the Morton-window kernels -------------------------------------------------------


def _morton_pair(seed, B, S, N, C, dev, dup=False):
    """Morton-ordered base ``[B,N,C]`` and query ``[B,S,C]``: for C = 3
    stride subsamples of one sorted cloud (how the model's scales relate
    after sorted FPS); wider, features in the same row order. ``dup``
    repeats rows, as S3DIS blocks drawn with replacement do."""
    M = max(S, N)
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, M, 3)).astype(np.float32)
    if dup:
        xyz[:, 1::4] = xyz[:, 0::4][:, : xyz[:, 1::4].shape[1]]
    cloud = morton_sort(torch.from_numpy(xyz))[0]
    if C != 3:
        cloud = torch.from_numpy(np.cumsum(rng.standard_normal((B, M, C)), 1).astype(np.float32)
                                 / 8)
    return cloud[:, :: M // N].contiguous().to(dev), cloud[:, :: M // S].contiguous().to(dev)


# (S, N, C) at the markov_semseg window_all shapes (16384 points; the la0
# self search, an encoder pair, the smallest encoder pair, the widest Fuse
# window) and ragged ones.
WINDOW_KNN = [(16384, 16384, 3, True), (8192, 16384, 64, False), (1024, 2048, 128, False),
              (1024, 16384, 3, False), (2048, 2048, 64, True), (256, 512, 5, True),
              (32, 64, 3, False), (64, 256, 16, False)]


@pytest.mark.parametrize("S,N,C,dup", WINDOW_KNN)
def test_windowed_knn_kernel_matches_plain(dev, S, N, C, dup):
    base, query = _morton_pair(S + C, 2, S, N, C, dev, dup)
    spec = make_window_spec(S, N)
    gd, gi = windowed_knn_cuda(8, base, query, spec)
    wd, wi = windowed_knn_plain(8, base, query, spec)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi), f"{int((gi != wi).sum())} indices differ"
    assert torch.equal(gd, wd)
    win0 = spec.window_start(dev)[None, :, None]
    assert bool(((gi >= win0) & (gi < win0 + spec.window)).all())


# (S, N, C, sq, k, cloud, form): each form of windowed_knn_form reached by
# the shape that picks it, (resident, threads a query) or (streaming,
# queries a thread), on knn_cloud's hard inputs: identical points, an
# integer grid (many exact ties), distances that fall as the index rises;
# sq = 8 and 64, so query tiles meet chunk edges; C = 5, 8, 9, 130; k = 1,
# 16, 17, 32 (lists of 8 and of 32). B = 2.
WINDOW_KNN_FORMS = [
    (1024, 16384, 3, 128, 8, "normal", (True, 32)),  # the widest Fuse window, 4096 rows
    (16384, 16384, 3, 128, 8, "normal", (True, 2)),  # la0's self search
    (32768, 32768, 3, 128, 8, "grid", (True, 1)),
    (8192, 16384, 3, 128, 8, "grid", (True, 4)),
    (2048, 4096, 5, 128, 16, "identical", (True, 16)),
    (64, 128, 3, 8, 8, "normal", (True, 8)),  # sq = 8: 16-row windows of 32
    (512, 1024, 5, 64, 16, "grid", (True, 32)),
    (256, 512, 5, 128, 1, "falling", (True, 32)),
    (512, 512, 3, 128, 8, "identical", (True, 32)),
    (1024, 2048, 3, 128, 32, "grid", (True, 32)),
    (4096, 8192, 3, 128, 17, "falling", (True, 8)),
    (8192, 8192, 8, 128, 8, "normal", (True, 4)),
    (1024, 16384, 8, 128, 8, "normal", (False, 1)),  # C = 8 past the resident bytes
    (8192, 16384, 64, 128, 8, "normal", (False, 4)),
    (8192, 8192, 32, 128, 8, "grid", (False, 4)),
    (8192, 16384, 64, 128, 32, "grid", (False, 4)),
    (2048, 4096, 64, 128, 16, "falling", (False, 1)),
    (1024, 2048, 128, 128, 17, "normal", (False, 1)),
    (256, 512, 130, 64, 32, "normal", (False, 1)),  # the query tile streamed
    (512, 1024, 9, 8, 17, "grid", (False, 1)),
    (256, 256, 16, 128, 8, "identical", (False, 1)),
    (1024, 2048, 64, 64, 32, "normal", (False, 1)),
]


@pytest.mark.parametrize("S,N,C,sq,k,cloud,form", WINDOW_KNN_FORMS)
def test_windowed_knn_kernel_forms_match_plain(dev, S, N, C, sq, k, cloud, form):
    base, query = knn_cloud(cloud, 2, N, S, C, False, False, seed=S + C)
    base, query = torch.from_numpy(base).to(dev), torch.from_numpy(query).to(dev)
    spec = make_window_spec(S, N, sq)
    assert windowed_knn_form(2, C, spec) == form
    gd, gi = windowed_knn_cuda(k, base, query, spec)
    wd, wi = windowed_knn_plain(k, base, query, spec)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi), f"{int((gi != wi).sum())} indices differ"
    assert torch.equal(gd, wd)
    win0 = spec.window_start(dev)[None, :, None]
    assert bool(((gi >= win0) & (gi < win0 + spec.window)).all())
    if cloud == "identical":  # every distance 0: each window's first k rows
        assert not gd.any()
        first = (win0 + torch.arange(k, device=dev)).to(torch.int32).expand_as(gi)
        assert torch.equal(gi, first)


def test_windowed_knn_kernel_misaligned_view(dev):
    # The streaming form reads rows as float4s: windowed_knn_cuda refuses a
    # view 4 bytes into its storage, and windowed_knn_with_spec copies it.
    base, query = knn_cloud("normal", 2, 2048, 1024, 64, False, False)
    flat = torch.from_numpy(np.concatenate([[0.0], base.ravel()]).astype(np.float32)).to(dev)
    view = flat[1:].view(base.shape)
    query = torch.from_numpy(query).to(dev)
    spec = make_window_spec(1024, 2048)
    with pytest.raises(ValueError, match="16-byte"):
        windowed_knn_cuda(8, view, query, spec)
    gd, gi, _ = windowed_knn_with_spec(8, view, query)
    wd, wi = windowed_knn_plain(8, view, query, spec)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def test_windowed_knn_gradient_matches_autograd_of_plain(dev):
    base, query = _morton_pair(3, 2, 512, 1024, 16, dev)
    w = torch.linspace(0.5, 1.5, 8, device=dev)
    grads = []
    for on_card in (True, False):
        b, q = base.clone().requires_grad_(True), query.clone().requires_grad_(True)
        if on_card:
            dist, _, _ = windowed_knn_with_spec(8, b, q)
        else:
            dist, _ = windowed_knn_plain(8, b, q, make_window_spec(512, 1024))
        grads.append(torch.autograd.grad((dist * w).sum(), (b, q)))
    for got, want in zip(*grads):
        _close(got, want, rtol=1e-5)


def _window_attention_inputs(dev, n_branches, with_shift, S, N, c, seed, outside=False, K=8):
    """packed, in-window idx from the windowed kNN (K neighbours), shifts and
    gctx, with a duplicate node (ties) and, with ``outside``, indices
    anywhere in [0, N)."""
    base, query = _morton_pair(seed, 2, S, N, 3, dev, dup=True)
    spec = make_window_spec(S, N)
    _, idx = windowed_knn_plain(K, base, query, spec)
    g = torch.Generator().manual_seed(seed)
    packed = torch.randn((2, N, n_branches * 2 * c), generator=g)
    for r in range(n_branches):
        e = slice(2 * r * c, (2 * r + 1) * c)
        packed[..., e] = packed[..., e].exp()
    packed = packed.to(dev)
    if outside:
        idx = torch.randint(0, N, idx.shape, generator=g, dtype=torch.int32).to(dev)
    shifts = torch.randn((2, S, n_branches * c), generator=g).to(dev) if with_shift else None
    gctx = torch.randn((2, S, n_branches * c), generator=g).to(dev)
    return spec, packed, idx, shifts, gctx


# (n_branches, shifts, S, N, c): the semseg window shapes (la0's 256-row
# window with shifts, an encoder pair's packed call at 512 rows, the decoder's
# self-attention) and ragged ones, up to a 4096-row window.
WINDOW_ATTENTION = [(1, True, 16384, 16384, 64), (2, True, 8192, 16384, 64),
                    (1, False, 8192, 16384, 64), (2, True, 1024, 2048, 256),
                    (1, False, 1024, 1024, 128), (2, False, 256, 512, 7),
                    (1, True, 1024, 16384, 24), (1, True, 64, 128, 3)]


@pytest.mark.parametrize("n_branches,with_shift,S,N,c", WINDOW_ATTENTION)
def test_windowed_attention_kernels_match_plain(dev, n_branches, with_shift, S, N, c):
    spec, packed, idx, shifts, gctx = _window_attention_inputs(
        dev, n_branches, with_shift, S, N, c, seed=S + c)
    got = windowed_attention_cuda(packed, idx, shifts, n_branches, c, spec)
    want = attention_plain(packed, idx, shifts, n_branches, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got_p, got_s = windowed_attention_bwd_cuda(packed, idx, shifts, gctx, n_branches, c, spec)
    want_p, want_s = attention_bwd_plain(packed, idx, shifts, gctx, n_branches, c)
    torch.cuda.synchronize()
    _close(got_p, want_p, rtol=1e-4)
    if with_shift:
        _close(got_s, want_s, rtol=1e-5)
    else:
        assert got_s is None


def test_windowed_attention_kernels_read_indices_outside_the_window(dev):
    """An index outside its window is still read (from device memory), not
    dropped: the kernels then compute the exact ops' function all the same."""
    spec, packed, idx, shifts, gctx = _window_attention_inputs(dev, 2, True, 1024, 2048, 16, 7,
                                                               outside=True)
    win0 = spec.window_start(dev)[None, :, None]
    assert bool(((idx < win0) | (idx >= win0 + spec.window)).any())
    got = windowed_attention_cuda(packed, idx, shifts, 2, 16, spec)
    assert torch.equal(got, attention_plain(packed, idx, shifts, 2, 16))
    got_p, got_s = windowed_attention_bwd_cuda(packed, idx, shifts, gctx, 2, 16, spec)
    want_p, want_s = attention_bwd_plain(packed, idx, shifts, gctx, 2, 16)
    _close(got_p, want_p, rtol=1e-4)
    _close(got_s, want_s, rtol=1e-5)


# (n_branches, with_shift, S, N, c, K, case, channels a thread): each form of
# attention_fwd_form in the windowed forward.
WINDOW_ATTENTION_FWD_CASES = [
    (1, True, 16384, 16384, 64, 8, "ties", 4),  # la0's self-window: 256 rows
    (2, True, 8192, 16384, 64, 8, "floored", 4),  # an encoder pair's packed call
    (2, False, 1024, 2048, 128, 16, "ties", 4),
    (1, True, 1024, 2048, 16, 5, "plain", 4),
    (1, True, 1024, 2048, 128, 8, "outside", 4),
    (1, True, 2048, 2048, 64, 16, "floored", 4),
    (2, True, 512, 1024, 7, 8, "floored", 1),
    (1, False, 512, 1024, 16, 33, "ties", 1),
    (2, True, 1024, 2048, 64, 33, "outside", 1),
    (2, False, 512, 1024, 7, 5, "outside", 1),
]


@pytest.mark.parametrize("n_branches,with_shift,S,N,c,K,case,vec", WINDOW_ATTENTION_FWD_CASES)
def test_windowed_attention_fwd_kernel_forms_match_plain(dev, n_branches, with_shift, S, N, c, K,
                                                         case, vec):
    """Each of ``attention_fwd_form``'s forms in the windowed forward,
    reached by the shape that picks it, bit-equal to the plain version:
    in-window indices with packed rows repeated in pairs (ties), a query
    whose neighbours all have E = 0 (the eps floor), indices anywhere in
    [0, N)."""
    spec, packed, idx, shifts, _ = _window_attention_inputs(
        dev, n_branches, with_shift, S, N, c, seed=S + c + K, outside=case == "outside", K=K)
    e_cols = torch.cat([torch.arange(2 * r * c, (2 * r + 1) * c) for r in range(n_branches)])
    if case == "ties":
        packed[:, 1::2] = packed[:, 0::2]
    elif case == "floored":
        for b in range(2):
            packed[b, idx[b, 1].long()[:, None], e_cols.to(dev)[None, :]] = 0.0
    elif case == "outside":
        win0 = spec.window_start(dev)[None, :, None]
        assert bool(((idx < win0) | (idx >= win0 + spec.window)).any())
    assert attention_fwd_form(packed, shifts, K, c) == vec
    got = windowed_attention_cuda(packed, idx, shifts, n_branches, c, spec)
    want = attention_plain(packed, idx, shifts, n_branches, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} places differ"
    assert torch.isfinite(got).all()  # the eps-floored query's attn is -1, not inf


@pytest.mark.parametrize("misaligned", ["packed", "shifts"])
def test_windowed_attention_fwd_kernel_misaligned_view(dev, misaligned):
    """A contiguous view 4 bytes into its storage takes one channel a thread
    (C % 4 == 0 notwithstanding) and still equals the plain version."""
    spec, packed, idx, shifts, _ = _window_attention_inputs(dev, 2, True, 1024, 2048, 32, 9)

    def shifted(t):
        flat = torch.cat([torch.zeros(1, device=dev), t.reshape(-1)])
        return flat[1:].view(t.shape)

    packed = shifted(packed) if misaligned == "packed" else packed
    shifts = shifted(shifts) if misaligned == "shifts" else shifts
    assert attention_fwd_form(packed, shifts, 8, 32) == 1
    got = windowed_attention_cuda(packed, idx, shifts, 2, 32, spec)
    assert torch.equal(got, attention_plain(packed, idx, shifts, 2, 32))


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("with_shift", [False, True])
@pytest.mark.parametrize("case", ["in_window", "outside", "ties"])
def test_windowed_attention_bwd_kernel_cases(dev, K, with_shift, case):
    """The backward at K = 8, 16 and 32 (its register templates), with and
    without shifts: in-window indices, indices anywhere in [0, N), and
    packed rows repeated in pairs, so that many queries meet neighbours tied
    for the maximum (the gradient split among the ties)."""
    n_branches, S, N, c = 2, 1024, 2048, 16
    spec, packed, idx, shifts, gctx = _window_attention_inputs(
        dev, n_branches, with_shift, S, N, c, seed=K, outside=case == "outside", K=K)
    if case == "ties":
        packed[:, 1::2] = packed[:, 0::2]
        rows = torch.gather(packed, 1, idx.long().reshape(2, S * K, 1).expand(-1, -1, packed.shape[2]))
        e, v = rows.reshape(2, S, K, n_branches, 2, c).unbind(4)
        if shifts is not None:
            v = v + shifts.reshape(2, S, 1, n_branches, c)
        w = (e / e.sum(2, keepdim=True) - 1) * v
        assert int(((w == w.amax(2, keepdim=True)).sum(2) > 1).sum()) > 1000  # many ties
    got_p, got_s = windowed_attention_bwd_cuda(packed, idx, shifts, gctx, n_branches, c, spec)
    want_p, want_s = attention_bwd_plain(packed, idx, shifts, gctx, n_branches, c)
    torch.cuda.synchronize()
    _close(got_p, want_p, rtol=1e-4)
    if with_shift:
        _close(got_s, want_s, rtol=1e-5)
    else:
        assert got_s is None


# (S, N, C): the semseg decoder and Fuse upsamples at 16384 points and ragged ones.
WINDOW_SCATTER = [(8192, 16384, 64), (1024, 16384, 64), (2048, 8192, 128), (256, 512, 37),
                  (16, 32, 300), (64, 64, 1)]


def test_windowed_scatter_mean_kernel_block_over_several_base_blocks(dev):
    """A launch whose 256-slot blocks each span two base blocks (bn = 128)
    and read their claims from the union of their windows' rows, and one
    whose blocks' claim ranges take two passes of 4096 indices (sq = 128,
    K = 24)."""
    for B, S, N, C, K, form in ((16, 8192, 8192, 64, 8, (256, 4)),
                                (1, 2048, 4096, 12, 24, (8, 4))):
        fine, coarse = _morton_pair(S + N + C, B, S, N, 3, dev, dup=True)
        spec = make_window_spec(S, N)
        _, idx = windowed_knn_plain(K, fine, coarse, spec)
        feats = torch.randn((B, S, C), generator=torch.Generator().manual_seed(C)).to(dev)
        assert windowed_scatter_mean_form(feats, N) == form
        rows = max(hi - lo for lo, hi in (block_claim_rows(spec, n0, form[0])
                                          for n0 in range(0, N, form[0])))
        assert spec.bn < form[0] or rows * K > 4096
        got, got_count = windowed_scatter_mean_cuda(feats, idx, N, spec)
        again, _ = windowed_scatter_mean_cuda(feats, idx, N, spec)
        torch.cuda.synchronize()
        cpu, cpu_count = scatter_mean_plain(feats.cpu(), idx.cpu(), N)
        assert torch.equal(got_count.cpu(), cpu_count)
        assert torch.equal(got.cpu(), cpu), f"{int((got.cpu() != cpu).sum())} places differ"
        assert torch.equal(got, again)


@pytest.mark.parametrize("S,N,C", WINDOW_SCATTER)
def test_windowed_scatter_mean_kernel_matches_plain(dev, S, N, C):
    fine, coarse = _morton_pair(S + N, 2, S, N, 3, dev, dup=True)
    spec = make_window_spec(S, N)
    _, idx = windowed_knn_plain(8, fine, coarse, spec)
    feats = torch.randn((2, S, C), generator=torch.Generator().manual_seed(C)).to(dev)
    got, got_count = windowed_scatter_mean_cuda(feats, idx, N, spec)
    torch.cuda.synchronize()
    cpu, cpu_count = scatter_mean_plain(feats.cpu(), idx.cpu(), N)
    assert torch.equal(got_count.cpu(), cpu_count)
    assert torch.equal(got.cpu(), cpu)  # the sequential order, bit for bit
    kernels.reset_launch_counts()
    f = feats.clone().requires_grad_(True)
    g = torch.randn((2, N, C), generator=torch.Generator().manual_seed(1)).to(dev)
    (grad,) = torch.autograd.grad(windowed_scatter_mean(f, idx, N, spec), f, g)
    assert kernels.LAUNCHES["windowed_scatter_mean_kernel"] == 1
    assert kernels.LAUNCHES["gather_rows_kernel"] == 1
    f = feats.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(scatter_mean_plain(f, idx, N)[0], f, g)
    torch.testing.assert_close(grad, want, rtol=1e-5, atol=1e-6)


def test_semantic_segmenter_on_cuda_matches_cpu_and_counts_launches(dev):
    """Launch counts of one window_all request at 16384 points, and the card
    against the CPU at the preset's 4096 points, B = 1, through
    ``chip_smoke.semseg_parity``, held to ``chip_smoke.SEMSEG_LIMITS``."""
    from mpa_tpu_torch.data import synthetic_semseg
    from mpa_tpu_torch.serve import load_semantic_segmenter

    blocks, _ = synthetic_semseg(1, 16384, seed=0)
    kernels.reset_launch_counts()
    got = load_semantic_segmenter(num_points=16384, neighbor_mode="window_all")(blocks[:2])
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == chip_smoke.SEMSEG_FORWARD
    assert tuple(got.shape) == (2, 16384, 13) and torch.isfinite(got).all()
    report = chip_smoke.semseg_parity()
    assert report["median_abs"] <= chip_smoke.SEMSEG_LIMITS["median_abs"], report
    assert report["argmax_agreement"] >= chip_smoke.SEMSEG_LIMITS["argmax_agreement"], report


def test_semseg_train_step_on_cuda_matches_cpu_and_counts_launches(dev):
    """One SGD step of ``s3dis_semseg`` window_all (B = 1 x 4096, dropout 0)
    on the card and on the CPU from the same weights, through
    ``chip_smoke.train_parity``, held to ``chip_smoke.py``'s limits."""
    parity = chip_smoke.train_parity("semseg")
    assert parity["launches"] == chip_smoke.PATHS["semseg"]["per_train_step"]
    assert parity["loss_diff"] <= 1e-4, parity["loss_diff"]
    name, units = parity["grad_units"][0]
    assert units <= chip_smoke.PATHS["semseg"]["grad_limit"], f"grad {name}: {units:.3f} units"
    name, err = parity["stat"]
    assert err < 1e-4, f"{name}: relative error {err:.3e}"


# -- FPS over 16384 points --------------------------------------------------------


def test_fps_kernel_at_16384_points(dev):
    """A 3-channel 16384-point cloud over a cluster of 8 CTAs, each holding
    the whole cloud (192 KB of shared memory), with repeated points."""
    pts = _cloud(6, (2, 16384, 3), dev, dup=True)
    got = fps_cuda(pts, 8192)
    want = fps_plain(pts, 8192)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# One shape (N, C) for each form (resident, cluster size, warps) that
# fps_form picks, at B = 3: resident (C = 3) on one block of 1, 15 and 16
# warps and on clusters of 4 and 8 CTAs, sliced (C = 5) on 1, 2, 4, 8 and
# 16 CTAs. N = 1000, 3000 and 5001 are multiples of no slice.
FPS_FORM_SHAPES = [(100, 3), (1000, 3), (2048, 3), (3000, 3), (5001, 3),
                   (256, 5), (500, 5), (1000, 5), (2000, 5), (3000, 5)]


@pytest.mark.parametrize("N,C", FPS_FORM_SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("case", ["starts", "dup", "coincident", "npoint_n", "scalar"])
def test_fps_kernel_forms_match_plain(dev, N, C, case):
    """Each form through the shape that picks it, against the plain version,
    bit for bit: per-cloud starts (a tensor on the card and one on the
    host), repeated points, all-coincident points (every distance 0),
    npoint = N (each point once) and one start for every cloud."""
    B = 3
    pts = _cloud(11, (B, N, C), dev, dup=case == "dup")
    if case == "coincident":
        pts = torch.zeros_like(pts)
    start = torch.tensor([0, N * 5 // 9, N - 1], dtype=torch.int32)
    start = N // 3 if case == "scalar" else start.to(dev) if case != "dup" else start
    npoint = N if case == "npoint_n" else min(N, 250)
    got = fps_cuda(pts, npoint, start)
    want = fps_plain(pts, npoint, start)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} picks differ"
    chain = fps_chain_cuda(pts, npoint, start)  # the chain floor's launch runs
    torch.cuda.synchronize()
    assert chain.shape == (B, npoint)


def test_fps_kernel_refuses_forms_fps_form_does_not_pick(dev):
    """``mpa_fps`` takes only ``fps_form``'s forms: a resident cluster of 2
    or 16, or a form with other warps, is refused, not launched."""
    from mpa_tpu_torch.kernels import build

    pts = _cloud(13, (2, 4096, 3), dev)
    out = torch.empty((2, 16), dtype=torch.int32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    for resident, cs, nw in [(1, 2, 4), (1, 16, 4), (1, 8, 2), (0, 4, 8), (0, 1, 4)]:
        err = lib.mpa_fps(pts.data_ptr(), None, 0, out.data_ptr(), 2, 4096, 3, 16, cs, nw,
                          resident, 0, stream)
        assert err != 0, (resident, cs, nw)
    assert lib.mpa_fps(pts.data_ptr(), None, 0, out.data_ptr(), 2, 4096, 3, 16,
                       *fps_form(2, 4096, 3)[1:], 1, 0, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, fps_plain(pts, 16))


@pytest.mark.parametrize("B,N,C,npoint", [(2, 2048, 64, 1024), (2, 1024, 64, 512),
                                          (2, 512, 64, 256), (2, 256, 128, 128),
                                          (2, 128, 256, 64), (32, 2048, 64, 128)])
def test_fps_kernel_feature_clouds(dev, B, N, C, npoint):
    """``markov_partseg_fp``'s feature FPS widths (la0: 512 KB a cloud, more
    than one block's shared memory), per-cloud starts, in the form
    ``fps_form`` picks."""
    pts = _cloud(N + C, (B, N, C), dev)
    start = torch.arange(B, dtype=torch.int32, device=dev) * 7 % N
    assert not fps_form(B, N, C)[0]
    got = fps_cuda(pts, npoint, start)
    want = fps_plain(pts, npoint, start)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"{int((got != want).sum())} picks differ"


def test_fps_kernel_at_16384_points_per_cloud_starts(dev):
    pts = _cloud(12, (2, 16384, 3), dev, dup=True)
    start = torch.tensor([5, 16000], dtype=torch.int32, device=dev)
    got = fps_cuda(pts, 4096, start)
    want = fps_plain(pts, 4096, start)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_window_mode_segmenter_at_16384_points(dev):
    """``markov_semseg`` in the ``window`` mode at 16384 points runs exact FPS
    over all of them on the card, once per request."""
    from mpa_tpu_torch.data import synthetic_semseg
    from mpa_tpu_torch.serve import load_semantic_segmenter

    blocks, _ = synthetic_semseg(1, 16384, seed=0)
    kernels.reset_launch_counts()
    kernels.recorded = []
    try:
        got = load_semantic_segmenter(num_points=16384, neighbor_mode="window")(blocks[:1])
        torch.cuda.synchronize()
        big = [inp for name, inp in kernels.recorded
               if name == "fps_kernel" and inp["points"].shape[1] == 16384]
    finally:
        kernels.recorded = None
    assert tuple(got.shape) == (1, 16384, 13) and torch.isfinite(got).all()
    assert len(big) == 1


# -- the ball query kernel ----------------------------------------------------------


def _ball_case(name, dev):
    """``(radius, nsample, xyz [B,N,C], new_xyz [B,S,C])`` on ``dev``."""
    B, N, S, C, ns, radius, scale = {
        "sa1": (4, 1024, 512, 3, 24, 0.1, 0.3),  # the three repsurf stages, B cut
        "sa2": (4, 512, 128, 3, 24, 0.2, 0.3),
        "sa3": (4, 128, 32, 3, 24, 0.4, 0.3),
        "ragged": (3, 1000, 77, 3, 24, 0.5, 1.0),  # N not a multiple of 32
        "sparse": (2, 257, 40, 3, 4, 0.2, 1.0),  # fewer hits than nsample
        "all_in": (2, 64, 16, 3, 64, 30.0, 1.0),  # everything in radius, nsample = N
        "tiles": (2, 5000, 100, 3, 24, 0.3, 1.0),  # two staged tiles of base rows
        "c6": (2, 300, 50, 6, 16, 0.8, 1.0),  # even C: padded shared-memory rows
        "c40": (1, 200, 33, 40, 8, 6.0, 1.0),  # wide C: centres in shared memory too
    }[name]
    r = np.random.default_rng(len(name) + N)
    xyz = (scale * r.standard_normal((B, N, C))).astype(np.float32)
    if name == "ragged":
        xyz[:, 1::3] = xyz[:, 0::3][:, : xyz[:, 1::3].shape[1]]  # repeated points
    new_xyz = xyz[:, r.permutation(N)[:S]] if name.startswith("sa") else xyz[:, :S]
    return radius, ns, torch.from_numpy(xyz).to(dev), torch.from_numpy(new_xyz).contiguous().to(dev)


BALL_CASES = ["sa1", "sa2", "sa3", "ragged", "sparse", "all_in", "tiles", "c6", "c40"]


@pytest.mark.parametrize("case", BALL_CASES)
def test_ball_query_kernel_matches_plain(dev, case):
    radius, ns, xyz, new_xyz = _ball_case(case, dev)
    kernels.reset_launch_counts()
    got = ball_query_cuda(radius, ns, xyz, new_xyz)
    want = ball_query_plain(radius, ns, xyz, new_xyz)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ball_query_kernel"] == 1
    assert torch.equal(got, want)
    hits = (want < xyz.shape[1]).sum(-1)
    if case == "sparse":
        assert (hits < ns).any()
    if case == "all_in":
        assert (hits == ns).all()
    # The backfilled groups on the card equal the CPU's.
    cpu = ball_query(radius, ns, xyz.cpu(), new_xyz.cpu())
    assert torch.equal(ball_query(radius, ns, xyz, new_xyz).cpu(), cpu)


def test_ball_query_kernel_identical_points_and_the_boundary(dev):
    """All points equal (every one in radius, distance 0), and a radius
    whose square in float32 equals one point's distance exactly."""
    xyz = torch.ones((2, 256, 3), device=dev)
    assert torch.equal(ball_query_cuda(0.5, 16, xyz, xyz[:, :64].contiguous()),
                       ball_query_plain(0.5, 16, xyz, xyz[:, :64].contiguous()))
    _, ns, xyz, new_xyz = _ball_case("sa2", dev)
    d = square_distance(new_xyz, xyz)
    radius = float(np.sqrt(np.float64(d[0, 0, 7].item())))
    assert radius_squared(radius) == d[0, 0, 7].item()
    got = ball_query_cuda(radius, ns, xyz, new_xyz)
    assert torch.equal(got, ball_query_plain(radius, ns, xyz, new_xyz))
    assert (got[0, 0] == 7).any()  # on the boundary: in the ball


def hit_cloud(B, N, S, C, ns, seed=0):
    """``(xyz [B,N,C], new_xyz [B,S,C])`` float32 numpy arrays whose centres
    at radius 0.3 hold 0, 1, exactly ``ns`` and more than ``ns`` hits, in
    turns: base points on a unit lattice in the first three channels (each
    alone in its ball), a centre 0.87 from every lattice point (no hit), on
    a lattice point (its own hit), or on a lattice point around which ns - 1
    or 2 ns - 1 rows, scattered over the cloud's indices, were moved to
    within 0.1 (the first ns of them in index order are its group). Also
    ``kinds [B,S]``: each centre's expected hit class (0, 1, 2 for ns, 3 for
    more)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(N ** (1 / 3)))
    lattice = np.stack(np.unravel_index(np.arange(N), (side, side, side)), -1).astype(np.float32)
    xyz = np.zeros((B, N, C), np.float32)
    xyz[..., :3] = lattice
    new_xyz = np.zeros((B, S, C), np.float32)
    kinds = np.zeros((B, S), np.int64)
    for b in range(B):
        perm, ptr = rng.permutation(N), 0
        for s in range(S):
            kind = s % 4
            need = {0: 0, 1: 1, 2: ns, 3: 2 * ns}[kind]
            if ptr + need > N:
                kind, need = 0, 0
            kinds[b, s] = kind
            if kind == 0:
                new_xyz[b, s, :3] = lattice[perm[s % N]] + 0.5
                continue
            anchor, members = perm[ptr], perm[ptr + 1:ptr + need]
            ptr += need
            offsets = rng.uniform(-0.1, 0.1, (len(members), C)) / np.sqrt(C)
            xyz[b, members] = xyz[b, anchor] + offsets.astype(np.float32)
            new_xyz[b, s] = xyz[b, anchor]
    return xyz, new_xyz, kinds


# (B, N, S, C, ns): N not a multiple of 32, S not a multiple of a block's
# centres (and, at B = 40, of a warp's eight), C = 3, 6 and 256, N = 16384,
# several staged tiles (C = 6 at 5000 rows, C = 256 at 700).
BALL_HIT_CASES = [
    (2, 1000, 77, 3, 24),
    (40, 600, 500, 3, 24),
    (2, 16384, 300, 3, 24),
    (2, 5000, 130, 6, 16),
    (2, 700, 45, 256, 8),
    (1, 16384, 64, 6, 24),
]


@pytest.mark.parametrize("B,N,S,C,ns", BALL_HIT_CASES)
def test_ball_query_kernel_hit_classes(dev, B, N, S, C, ns):
    xyz, new_xyz, kinds = hit_cloud(B, N, S, C, ns)
    xyz, new_xyz = torch.from_numpy(xyz).to(dev), torch.from_numpy(new_xyz).to(dev)
    kernels.reset_launch_counts()
    got = ball_query_cuda(0.3, ns, xyz, new_xyz)
    want = ball_query_plain(0.3, ns, xyz, new_xyz)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ball_query_kernel"] == 1
    assert torch.equal(got, want)
    hits = (want < N).sum(-1).cpu().numpy()
    assert set(kinds.flatten()) == {0, 1, 2, 3}
    assert (hits[kinds == 0] == 0).all() and (hits[kinds == 1] == 1).all()
    assert (hits[kinds >= 2] == ns).all()
    if B == 40:
        assert ball_query_form(B, S) == 8 and S % 8 != 0


@pytest.mark.parametrize("C", [3, 6, 256])
def test_ball_query_kernel_within_a_last_bit_of_r2(dev, C):
    """For several (centre, point) pairs, r2 set to their float32 distance
    and to the floats just below and above it: the point joins the ball
    exactly from r2 = d on, on the card as in the plain version (nsample =
    N, so every hit is listed)."""
    rng = np.random.default_rng(C)
    xyz = torch.from_numpy((0.3 * rng.standard_normal((2, 300, C))).astype(np.float32)).to(dev)
    new_xyz = xyz[:, 10:50].contiguous()
    d = square_distance(new_xyz, xyz)
    for b, s, n in [(0, 0, 7), (1, 5, 299), (0, 39, 31), (1, 17, 32)]:
        t = np.float32(d[b, s, n].item())
        for r2 in (np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(np.inf))):
            radius = float(np.sqrt(np.float64(r2)))
            assert radius_squared(radius) == r2
            got = ball_query_cuda(radius, 300, xyz, new_xyz)
            assert torch.equal(got, ball_query_plain(radius, 300, xyz, new_xyz))
            assert bool((got[b, s] == n).any()) == bool(r2 >= t)


def test_ball_query_kernel_nan_rows_and_centres(dev):
    """A NaN coordinate puts a point, or a centre's whole ball, out: the
    plain version's clamp keeps a NaN distance NaN, which no radius admits."""
    xyz = (0.2 * torch.randn((2, 200, 3), generator=torch.Generator().manual_seed(4))).to(dev)
    xyz[0, 3, 1] = float("nan")
    xyz[1, 150:, 0] = float("nan")
    new_xyz = xyz[:, :40].contiguous()
    new_xyz[1, 5, 2] = float("nan")
    got = ball_query_cuda(0.2, 16, xyz, new_xyz)
    assert torch.equal(got, ball_query_plain(0.2, 16, xyz, new_xyz))
    assert not (got[0] == 3).any() and (got[1, 5] == 200).all()


def test_repsurf_classifier_on_cuda_matches_cpu_and_counts_launches(dev):
    """One request of ``scanobjectnn_2x`` at full width (B = 4 x 1024
    ``surface_clouds``): launch counts, and the card against the CPU plain
    ops from the same weights within 1e-3."""
    from mpa_tpu_torch.data import surface_clouds

    x, _ = surface_clouds(4, 1024, seed=5)
    gpu = load_classifier("scanobjectnn_2x", seed=0)
    cpu = load_classifier("scanobjectnn_2x", device="cpu", seed=0)
    kernels.reset_launch_counts()
    got = gpu(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == chip_smoke.REPSURF_FORWARD
    torch.testing.assert_close(got.cpu(), cpu(x), rtol=0, atol=1e-3)


def test_repsurf_train_step_on_cuda_matches_cpu_and_counts_launches(dev):
    """One adam-l2 step of ``scanobjectnn_2x`` (B = 16 x 1024, dropout 0,
    the same umbrella flips) on the card and on the CPU from the same
    weights, through ``chip_smoke.train_parity``, held to ``chip_smoke.py``'s
    limits."""
    parity = chip_smoke.train_parity("repsurf")
    assert parity["launches"] == chip_smoke.PATHS["repsurf"]["per_train_step"]
    assert parity["loss_diff"] <= 1e-4, parity["loss_diff"]
    name, units = parity["grad_units"][0]
    assert units <= chip_smoke.PATHS["repsurf"]["grad_limit"], f"grad {name}: {units:.3f} units"
    name, err = parity["stat"]
    assert err < 1e-4, f"{name}: relative error {err:.3e}"
