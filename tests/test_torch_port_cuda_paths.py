"""Port kernels on the card at the shapes of ``markov_partseg_fp``,
``markov_pose``, ``markov_completion``, the served part-seg window
modes and exact ``markov_semseg`` on 4096-point S3DIS blocks: ``knn_kernel`` with k = 3 and a coarse base of far fewer points than
its fine queries (the 3-NN interpolation, base 3 to 1024, queries to 2048),
``fps_kernel`` with npoint = N (completion's 512-point partial clouds) and
on ``markov_partseg_fp``'s feature clouds at B = 32, the gather of the
interpolation's ``[B, 3N]`` rows and its scatter-add backward (three edges a
fine row into few coarse rows), ``three_nn_interpolate`` on the card against
the plain ops and autograd; then each new path through ``chip_smoke.py``'s
helpers: the served model's launch counts and answers against the CPU, and
one train step against the CPU (``chip_smoke.train_parity``, its limits).

Tolerances: the kNN, FPS and gather bit for bit with the plain versions;
the scatter-add bit for bit with the plain version run on the CPU (its
order), and within 1e-5 relative plus 1e-6 for each row a slot sums of
the plain one on the card (atomic ``index_add_``: a slot of S = 3 sums
about 1000 rows, and read 5.4e-5 apart);
the interpolation's feature gradient bit for bit the plain scatter-add
of the card's own edge products, and against the CPU its values within
1e-6 and its feature gradient within 1e-6 relative plus 1e-6 (the
weights' 3-term sum associates differently there). Every test needs a CUDA card
(the kernels have no CPU mode) and skips, through the ``dev`` fixture,
without one.

Run on a machine with an H100, from the repo root:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda_paths.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mpa_tpu_torch import kernels
from mpa_tpu_torch.ops import three_nn_interpolate
from mpa_tpu_torch.ops.fps import fps_cuda, fps_form, fps_plain
from mpa_tpu_torch.ops.gather import (
    gather_cuda, gather_plain, scatter_add_cuda, scatter_add_form, scatter_add_plain,
)
from mpa_tpu_torch.ops.knn import knn_cuda, knn_plain
from mpa_tpu_torch.serve import load_segmenter


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cloud(seed, shape, dev):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dev)


# (B, coarse base S, fine queries N, queries on base points): the preset
# ladder's four interpolations at B = 32, the default ladder's last, and
# ragged ones down to S = k.
KNN3_CASES = [(32, 1024, 2048, True), (32, 512, 1024, False), (32, 256, 512, False),
              (32, 128, 256, True), (32, 64, 128, False), (2, 3, 1000, False),
              (3, 5, 777, True), (1, 130, 4097, False)]


@pytest.mark.parametrize("B,S,N,on_base", KNN3_CASES)
def test_knn_kernel_k3_coarse_base_matches_plain(dev, B, S, N, on_base):
    base = _cloud(S, (B, S, 3), dev)
    query = _cloud(N, (B, N, 3), dev)
    if on_base:  # fine points on coarse ones: distance 0, as FPS picks them
        query[:, :S] = base
    gd, gi = knn_cuda(3, base, query)
    wd, wi = knn_plain(3, base, query)
    assert torch.equal(gi, wi), f"{int((gi != wi).sum())} indices differ"
    assert torch.equal(gd, wd), f"{int((gd != wd).sum())} distances differ"


# (B, N, npoint, C): npoint = N (completion's first level, and ragged), and
# markov_partseg_fp's feature clouds at B = 32 (la0 .. la3's outputs).
FPS_CASES = [(64, 512, 512, 3), (2, 300, 300, 3), (4, 512, 512, 64),
             (32, 2048, 1024, 64), (32, 1024, 512, 64), (32, 512, 256, 64),
             (32, 256, 128, 128)]


@pytest.mark.parametrize("B,N,npoint,C", FPS_CASES)
def test_fps_kernel_new_path_shapes_match_plain(dev, B, N, npoint, C):
    pts = _cloud(N + C, (B, N, C), dev)
    got = fps_cuda(pts, npoint)
    want = fps_plain(pts, npoint)
    assert torch.equal(got, want), f"{int((got != want).sum())} picks differ ({fps_form(B, N, C)})"
    if npoint == N:  # every point once
        assert torch.equal(got.sort(-1).values,
                           torch.arange(N, device=dev, dtype=got.dtype).expand(B, N))


# (B, S coarse rows, N fine rows, C): the interpolations' gathers of [B, 3N]
# rows and their scatter-add backward into S rows.
INTERP_ROWS = [(32, 1024, 2048, 64), (32, 512, 1024, 64), (32, 256, 512, 64),
               (32, 128, 256, 128), (2, 3, 1000, 64), (2, 7, 300, 5)]


@pytest.mark.parametrize("B,S,N,C", INTERP_ROWS)
def test_gather_and_scatter_add_of_interpolation_rows(dev, B, S, N, C):
    feats = _cloud(B * S, (B, S, C), dev)
    _, idx = knn_plain(3, _cloud(1, (B, S, 3), dev), _cloud(2, (B, N, 3), dev))
    flat = idx.reshape(B, 3 * N).contiguous()
    assert torch.equal(gather_cuda(feats, flat), gather_plain(feats, flat))
    grads = _cloud(3, (B, 3 * N, C), dev)
    got = scatter_add_cuda(grads, flat, S)
    assert torch.equal(got.cpu(), scatter_add_plain(grads.cpu(), flat.cpu(), S)), (
        scatter_add_form(grads, S))
    # The card's index_add_ adds in no fixed order: a slot's sum of up to
    # ~1000 rows (S = 3) moves by about 1e-6 a row.
    edges = int(torch.bincount((flat.long() + torch.arange(B, device=dev)[:, None] * S)
                               .reshape(-1)).max())
    torch.testing.assert_close(got, scatter_add_plain(grads, flat, S), rtol=1e-5,
                               atol=1e-6 * edges)


def test_three_nn_interpolate_on_cuda_matches_plain(dev):
    """Forward through ``knn_kernel`` and ``gather_rows_kernel``, backward
    into the features through ``scatter_add_rows_kernel``: the feature
    gradient bit for bit the plain scatter-add, on the CPU, of the card's
    own edge products; and the whole function against the same on the CPU.
    There the weights' 3-term sum associates differently (read: weights
    2.3e-7 relative apart, the gradient 1.431e-6 at an entry of 5.4), so
    the gradient is held within 1e-6 relative plus 1e-6."""
    fine, coarse = _cloud(4, (4, 2048, 3), dev), _cloud(5, (4, 1024, 3), dev)
    feats, g = _cloud(6, (4, 1024, 64), dev), _cloud(7, (4, 2048, 64), dev)
    outs = []
    for device in (dev, torch.device("cpu")):
        f = feats.detach().to(device).requires_grad_(True)
        kernels.reset_launch_counts()
        out = three_nn_interpolate(fine.to(device), coarse.to(device), f)
        (out * g.to(device)).sum().backward()
        outs.append((out.detach().cpu(), f.grad.cpu(), dict(kernels.LAUNCHES)))
    (got, ggot, launches), (want, gwant, _) = outs
    assert {k: v for k, v in launches.items() if v} == {
        "knn_kernel": 1, "gather_rows_kernel": 1, "scatter_add_rows_kernel": 1}
    d, idx = knn_plain(3, coarse, fine)
    w = 1.0 / (d + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    edges = (g[:, :, None, :] * w[..., None]).reshape(4, -1, 64)
    assert torch.equal(ggot, scatter_add_plain(edges.cpu(), idx.reshape(4, -1).cpu(), 1024))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(ggot, gwant, rtol=1e-6, atol=1e-6)


# -- the paths, through chip_smoke's helpers ----------------------------------------------


def test_partseg_fp_segmenter_on_cuda_matches_cpu_and_counts_launches(dev):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 2048, 3)).astype(np.float32)
    kernels.reset_launch_counts()
    got = load_segmenter("shapenetpart_fp", seed=0)(x, rng.integers(0, 16, 2))
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == chip_smoke.PARTSEG_FP_FORWARD
    assert tuple(got.shape) == (2, 2048, 50) and torch.isfinite(got).all()
    report = chip_smoke.segmenter_parity(preset="shapenetpart_fp")
    assert chip_smoke.within(report, chip_smoke.SEG_LIMITS), report


@pytest.mark.parametrize("path", ["pose", "completion"])
def test_cloud_paths_on_cuda_match_cpu_and_count_launches(dev, path):
    report = chip_smoke.cloud_parity(path)
    launches = {}
    for name, _ in report["recorded"]:
        launches[name] = launches.get(name, 0) + 1
    assert launches == chip_smoke.PATHS[path]["per_forward"] == chip_smoke.CLS_FORWARD
    assert chip_smoke.within(report, chip_smoke.CLOUD_LIMITS), report


def test_s3dis_exact_semseg_on_cuda_matches_cpu_and_counts_launches(dev):
    """One exact 4096-point block through ``load_semantic_segmenter``:
    part-seg's launches, the log-probs within ``SEMSEG_LIMITS``."""
    report = chip_smoke.semseg_parity("s3dis")
    launches = {}
    for name, _ in report["recorded"]:
        launches[name] = launches.get(name, 0) + 1
    assert launches == chip_smoke.S3DIS_PATH["per_forward"] == chip_smoke.PARTSEG_FORWARD
    assert chip_smoke.within(report, chip_smoke.SEMSEG_LIMITS), report


@pytest.mark.parametrize("path", ["partseg_fp", "pose", "completion", "s3dis"])
def test_new_path_train_steps_on_cuda_match_cpu(dev, path):
    """One step of the path's preset (dropout 0) on the card and on the CPU
    from the same weights, held to ``chip_smoke.py``'s limits."""
    parity = chip_smoke.train_parity(path)
    spec = chip_smoke.path_spec(path)
    assert parity["launches"] == spec["per_train_step"]
    assert parity["loss_diff"] <= 1e-4, parity["loss_diff"]
    name, units = parity["grad_units"][0]
    assert units <= spec["grad_limit"], f"grad {name}: {units:.3f} units"
    name, err = parity["stat"]
    assert err < 1e-4, f"{name}: relative error {err:.3e}"


@pytest.mark.parametrize("mode", ["window", "window_all"])
def test_partseg_window_segmenter_on_cuda_matches_cpu_and_counts_launches(dev, mode):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 2048, 3)).astype(np.float32)
    kernels.reset_launch_counts()
    got = load_segmenter(seed=0, neighbor_mode=mode)(x, rng.integers(0, 16, 2))
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == (
        chip_smoke.PARTSEG_WINDOW_FORWARD[mode])
    assert tuple(got.shape) == (2, 2048, 50) and torch.isfinite(got).all()
    report = chip_smoke.segmenter_parity(neighbor_mode=mode)
    assert chip_smoke.within(report, chip_smoke.SEG_LIMITS), report
