"""The benchmark's copies of the program's arithmetic give what the originals
give on fixed inputs, and each configuration's operation count agrees with
``FlopCounterMode`` over the reference on its matrix products."""

from __future__ import annotations

import json
import random
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import roofline
from portbench.conftest import ROOT
from portbench.traffic import shapenetpart_parts, surface_clouds

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from mpa_tpu_torch.data import shapenetpart, synthetic  # noqa: E402
from mpa_tpu_torch.utils import profiling  # noqa: E402


def test_partseg_traffic_is_the_programs():
    got = shapenetpart_parts.realistic_partseg(6, 256, seed=41)
    want = synthetic.realistic_partseg(6, 256, seed=41)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert shapenetpart_parts.SEG_PARTS == shapenetpart.SEG_PARTS


def test_surface_traffic_is_the_programs():
    got = surface_clouds.realistic_clouds(6, 256, 15, seed=43)
    want = synthetic.realistic_clouds(6, 256, 15, seed=43)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


KERNEL_NAMES = [
    "void (anonymous namespace)::knn_kernel_stream<4, true>(mpa::knn::Args)",
    "(anonymous namespace)::knn_kernel_resident(float const*, int)",
    "windowed_knn_kernel<8>", "fps_slice_kernel<4>", "fps_kernel_resident",
    "gather_rows_kernel<float>", "transition_attention_fwd_kernel<8, 4, float>",
    "transition_attention_bwd_kernel", "scatter_add_rows_kernel", "scatter_mean_kernel",
    "windowed_scatter_mean_kernel", "windowed_attention_fwd_kernel",
    "windowed_attention_bwd_kernel", "ball_query_kernel",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "cutlass_80_simt_sgemm_256x128",
    "ampere_sgemm_128x64_nn", "Memcpy DtoH (Device -> Pageable)",
    "void at::native::batch_norm_transform_input_channels_last_kernel<float>",
    "void at::native::vectorized_elementwise_kernel<4, leaky_relu>",
]


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_category_is_the_programs(name):
    assert roofline.kernel_category(name) == profiling.kernel_category(name)


def _inputs(seed: int):
    g = torch.Generator().manual_seed(seed)
    B, N, S, C, K = 2, 96, 32, 16, 8
    idx = torch.randint(0, N, (B, S, K), generator=g, dtype=torch.int32)
    packed = torch.randn(B, N, 4 * C, generator=g)
    shifts = torch.randn(B, S, 2 * C, generator=g)
    xyz = torch.rand(B, N, 3, generator=g)
    return {
        "knn_kernel": {"k": K, "base": torch.randn(B, N, C, generator=g),
                       "query": torch.randn(B, S, C, generator=g)},
        "windowed_knn_kernel": {"k": K, "base": torch.randn(B, N, C, generator=g),
                                "query": torch.randn(B, S, C, generator=g),
                                "spec": SimpleNamespace(window=48)},
        "ball_query_kernel": {"xyz": xyz, "new_xyz": xyz[:, :S].clone(), "radius": 0.2,
                              "nsample": 8},
        "fps_kernel": {"points": xyz, "npoint": S, "start": 0},
        "gather_rows_kernel": {"points": torch.randn(B, N, C, generator=g),
                               "idx": idx.reshape(B, S * K)},
        "scatter_add_rows_kernel": {"grads": torch.randn(B, S * K, C, generator=g),
                                    "idx": idx.reshape(B, S * K), "num_points": N},
        "scatter_mean_kernel": {"features": torch.randn(B, S, C, generator=g), "knn_idx": idx,
                                "num_fine": N},
        "transition_attention_fwd_kernel": {"packed": packed, "idx": idx, "shifts": shifts,
                                            "n_branches": 2, "c": C},
        "transition_attention_bwd_kernel": {"packed": packed, "idx": idx, "shifts": None,
                                            "n_branches": 2, "c": C},
    }


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(_inputs(0)))
def test_bound_is_the_programs(name, seed):
    inp = _inputs(seed)[name]
    assert roofline.bound(name, inp) == chip_smoke.bound(name, inp)


def test_busy_seconds_is_a_union():
    rnd = random.Random(5)
    spans = []
    for _ in range(200):
        a = rnd.uniform(0, 10)
        spans.append((a, a + rnd.uniform(0, 0.2)))
    grid = np.linspace(0, 11, 110001)
    covered = np.zeros_like(grid, dtype=bool)
    for a, b in spans:
        covered |= (grid >= a) & (grid < b)
    assert abs(roofline.busy_seconds(spans) - covered.mean() * 11) < 1e-3
    gaps = roofline.idle_gaps(spans, 0.0, 11.0)
    assert abs(sum(b - a for a, b in gaps) + roofline.busy_seconds(spans) - 11.0) < 1e-9


def _matmul_flops(model, *args) -> int:
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.eval()(*args)
    return int(counter.get_total_flops())


def test_partseg_count_is_the_references_products():
    from portbench.configs import markov_partseg_shapenetpart as cfg

    sizes = json.loads((ROOT / "portbench/configs/markov_partseg_shapenetpart.json").read_text())
    sizes.update(num_points=128, npoints=[64, 32, 16, 8])
    model = _init(cfg.reference(sizes))
    pts, cat = torch.rand(2, 128, 3), torch.tensor([3, 7])
    assert cfg.count_ops(sizes, 2, 128)["matmul"] == _matmul_flops(model, pts, cat)


def test_dgcnn_count_is_the_references_products():
    from portbench.configs import dgcnn_scanobjectnn as cfg

    sizes = json.loads((ROOT / "portbench/configs/dgcnn_scanobjectnn.json").read_text())
    model = _init(cfg.reference(sizes))
    assert cfg.count_ops(sizes, 2, 64)["matmul"] == _matmul_flops(model, torch.rand(2, 64, 3))


def _init(model):
    from portbench import weights
    from portbench.reference.layers import weight_table

    model.load_state_dict(weights.make(weight_table(model), 9, torch.device("cpu")))
    return model
