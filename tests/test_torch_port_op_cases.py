"""The arguments of each ``mpa::`` op at small shapes, with its plain
version's outputs, shared by the CPU test of the ops' fakes
(``test_torch_port_custom_ops.py``) and their ``opcheck`` on the card
(``test_torch_port_cuda.py``); the same for the shapes of DGCNN's and
Disp3D's launches (``PATH_CASES``); and, on the CPU, that the cases cover
every op, in bf16 exactly the ops of the kernels that take bf16 storage.
Imports no JAX.
"""

import numpy as np
import torch

from mpa_tpu_torch import kernels
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.ops.attention import attention_bwd_plain, attention_plain
from mpa_tpu_torch.ops.ball_query import ball_query_plain
from mpa_tpu_torch.ops.batch_norm import batch_norm_act_bwd_plain, batch_norm_act_plain
from mpa_tpu_torch.ops.fps import fps_plain
from mpa_tpu_torch.ops.gather import gather_plain, scatter_add_plain
from mpa_tpu_torch.ops.knn import knn_plain
from mpa_tpu_torch.ops.scatter import scatter_mean_plain
from mpa_tpu_torch.ops.window import make_window_spec, windowed_knn_plain

B, N, S, K, C = 2, 64, 32, 8, 6
NB, CB = 2, 4  # attention branches and channels a branch: packed width 16
SPEC = make_window_spec(S, N, sq=8)  # four chunks of 8 queries over 16-row node blocks
BF16_OPS = ("gather", "scatter_add", "attention", "attention_bwd", "scatter_mean",
            "windowed_attention", "windowed_attention_bwd", "windowed_scatter_mean")
ATTENTION_OPS = ("attention", "attention_bwd", "windowed_attention", "windowed_attention_bwd")
# The kernel each op launches.
OP_KERNELS = {
    "knn": "knn_kernel", "fps": "fps_kernel", "gather": "gather_rows_kernel",
    "scatter_add": "scatter_add_rows_kernel", "attention": "transition_attention_fwd_kernel",
    "attention_bwd": "transition_attention_bwd_kernel", "scatter_mean": "scatter_mean_kernel",
    "windowed_knn": "windowed_knn_kernel", "windowed_attention": "windowed_attention_fwd_kernel",
    "windowed_attention_bwd": "windowed_attention_bwd_kernel",
    "windowed_scatter_mean": "windowed_scatter_mean_kernel", "ball_query": "ball_query_kernel",
    "batch_norm_act": "batch_norm_act_kernel", "batch_norm_act_bwd": "batch_norm_act_bwd_kernel",
}


def _rand(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _window_idx(rng):
    """``[B, S, K]`` int32 indices, each inside its query row's window."""
    win0 = SPEC.window_start()[None, :, None]
    return (win0 + torch.from_numpy(rng.integers(0, SPEC.window, (B, S, K)))).to(torch.int32)


def case(name: str, dtype: torch.dtype, shifted: bool):
    """``(op arguments, plain outputs)`` for op ``name`` on CPU inputs
    (``shifted``: the attention ops with value shifts)."""
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, N, (B, S, K))).to(torch.int32)
    if name == "knn":
        base, query = _rand(rng, (B, N, C)), _rand(rng, (B, S, C))
        return (K, base, query), knn_plain(K, base, query)
    if name == "windowed_knn":
        base, query = _rand(rng, (B, N, C)), _rand(rng, (B, S, C))
        return ((K, base, query, SPEC.sq, SPEC.bn, SPEC.n_chunks),
                windowed_knn_plain(K, base, query, SPEC))
    if name == "fps":
        points = _rand(rng, (B, N, 3))
        return (points, S, 0, None), fps_plain(points, S, 0)
    if name == "gather":
        points, flat = _rand(rng, (B, N, C), dtype), idx.reshape(B, S * K)
        return (points, flat), gather_plain(points, flat)
    if name == "scatter_add":
        grads, flat = _rand(rng, (B, S * K, C), dtype), idx.reshape(B, S * K)
        return (grads, flat, N), scatter_add_plain(grads, flat, N)
    if name in ("scatter_mean", "windowed_scatter_mean"):
        feats = _rand(rng, (B, S, C), dtype)
        args = (feats, idx, N)
        if name == "windowed_scatter_mean":
            args = (feats, _window_idx(rng), N, SPEC.sq, SPEC.bn, SPEC.n_chunks)
        return args, scatter_mean_plain(*args[:3])
    if name in ATTENTION_OPS:
        packed = _rand(rng, (B, N, 2 * NB * CB), dtype).abs() + 0.1
        shifts = _rand(rng, (B, S, NB * CB), dtype) if shifted else None
        if name.startswith("windowed"):
            idx = _window_idx(rng)
        spec = (SPEC.sq, SPEC.bn, SPEC.n_chunks) if name.startswith("windowed") else ()
        if name.endswith("bwd"):
            gctx = _rand(rng, (B, S, NB * CB), dtype)
            return ((packed, idx, shifts, gctx, NB, CB) + spec,
                    attention_bwd_plain(packed, idx, shifts, gctx, NB, CB))
        return (packed, idx, shifts, NB, CB) + spec, attention_plain(packed, idx, shifts, NB, CB)
    if name == "ball_query":
        xyz, centres = _rand(rng, (B, N, 3)), _rand(rng, (B, S, 3))
        return (0.8, K, xyz, centres), ball_query_plain(0.8, K, xyz, centres)
    if name in ("batch_norm_act", "batch_norm_act_bwd"):
        x, w, b = _rand(rng, (N, C)), _rand(rng, (C,)), _rand(rng, (C,))
        mean, rstd = x.mean(dim=0), torch.rsqrt(x.var(dim=0, unbiased=False) + 1e-5)
        if name == "batch_norm_act_bwd":
            dy = _rand(rng, (N, C))
            return (dy, x, w, b, mean, rstd, True), batch_norm_act_bwd_plain(dy, x, w, b, mean,
                                                                             rstd, True)
        stats = (torch.zeros(C), torch.ones(C))
        y = batch_norm_act_plain(x, w, b, *(t.clone() for t in stats), 1e-5, 0.1, True)
        return (x, w, b) + stats + (1e-5, 0.1, True), (y, mean, rstd)
    raise KeyError(name)


CASES = ([(name, torch.float32, False) for name in library.OPS if name not in ATTENTION_OPS]
         + [(name, torch.bfloat16, False) for name in BF16_OPS if name not in ATTENTION_OPS]
         + [(name, dtype, shifted) for name in ATTENTION_OPS
            for dtype in (torch.float32, torch.bfloat16) for shifted in (False, True)])


def case_id(name: str, dtype: torch.dtype, shifted: bool) -> str:
    return f"{name}-{str(dtype)[6:]}{'-shifted' if shifted else ''}"


# The DGCNN and Disp3D launches at narrowed B and N: knn_kernel at k = 20 over
# feature clouds of C = 64 and 128 and at k = 16 over xyz, and the gather and
# scatter-add of an EdgeConv block's [B, N * 20] rows at C = 128.
PATH_CASES = {
    "dgcnn-knn-k20-c64": ("knn", 20, 64),
    "dgcnn-knn-k20-c128": ("knn", 20, 128),
    "disp3d-knn-k16-c3": ("knn", 16, 3),
    "dgcnn-gather-k20-c128": ("gather", 20, 128),
    "dgcnn-scatter_add-k20-c128": ("scatter_add", 20, 128),
}


def path_case(case: str):
    """``(op name, op arguments, plain outputs)`` of ``PATH_CASES[case]`` on
    CPU inputs: ``[2, 96, C]`` clouds (the kNN against themselves, as
    DGCNN's and Disp3D's searches are), ``[2, 96 * k]`` rows."""
    name, k, c = PATH_CASES[case]
    rng = np.random.default_rng(1)
    n = 96
    if name == "knn":
        points = _rand(rng, (B, n, c))
        return name, (k, points, points), knn_plain(k, points, points)
    idx = torch.from_numpy(rng.integers(0, n, (B, n * k))).to(torch.int32)
    if name == "gather":
        points = _rand(rng, (B, n, c))
        return name, (points, idx), gather_plain(points, idx)
    grads = _rand(rng, (B, n * k, c))
    return name, (grads, idx, n), scatter_add_plain(grads, idx, n)


def test_cases_cover_every_op_and_its_storage_types():
    assert set(OP_KERNELS) == set(library.OPS)
    assert sorted(OP_KERNELS.values()) == sorted(kernels.KERNELS + kernels.NORM_KERNELS)
    assert sorted(OP_KERNELS[n] for n in BF16_OPS) == sorted(kernels.BF16_KERNELS)
    assert {n for n, d, _ in CASES if d == torch.float32} == set(library.OPS)
    assert {n for n, d, _ in CASES if d == torch.bfloat16} == set(BF16_OPS)
