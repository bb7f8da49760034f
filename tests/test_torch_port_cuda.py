"""Port kernels on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, at shapes around the model's, including
the tie cases. Every test here needs a CUDA card (the kernels have no CPU
mode) and skips, through the ``dev`` fixture, without one.

Run on a machine with an H100:
    python -m pytest tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mpa_tpu_torch import kernels
from mpa_tpu_torch.ops.attention import attention_cuda, attention_plain
from mpa_tpu_torch.ops.fps import fps_cuda, fps_plain
from mpa_tpu_torch.ops.gather import gather_cuda, gather_plain
from mpa_tpu_torch.ops.knn import knn_cuda, knn_plain
from mpa_tpu_torch.serve import load_classifier


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


@pytest.mark.parametrize(
    "k,N,S,C,dup,self_query",
    [
        (8, 1024, 1024, 3, True, True),
        (8, 1024, 512, 64, False, False),
        (8, 64, 32, 256, False, False),
        (16, 300, 77, 5, True, False),
        (64, 200, 40, 600, False, False),
        (8, 100, 50, 1024, False, False),
    ],
)
def test_knn_kernel_matches_plain(dev, k, N, S, C, dup, self_query):
    base = _cloud(0, (2, N, C), dev, dup)
    query = base if self_query else _cloud(1, (2, S, C), dev)
    gd, gi = knn_cuda(k, base, query)
    wd, wi = knn_plain(k, base, query)
    torch.cuda.synchronize()
    assert torch.equal(gi, wi)
    assert torch.equal(gd, wd)


@pytest.mark.parametrize("N,npoint,C,dup", [(1024, 512, 3, False), (2048, 1024, 3, True),
                                              (100, 37, 3, False), (512, 64, 6, True)])
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
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_classifier_on_cuda_matches_cpu_and_counts_launches(dev):
    x = np.random.default_rng(4).standard_normal((4, 1024, 3)).astype(np.float32)
    gpu = load_classifier(seed=0)
    cpu = load_classifier(device="cpu", seed=0)
    kernels.reset_launch_counts()
    got = gpu(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"knn_kernel": 11, "fps_kernel": 5, "gather_rows_kernel": 10,
                                "transition_attention_fwd_kernel": 11}
    torch.testing.assert_close(got.cpu(), cpu(x), rtol=0, atol=1e-3)
