"""``markov_semseg`` in the Morton-window mode against the benchmark's plain
reference (``portbench/reference/markov_semseg.py``, ``window_ops.py``), on
the CPU at 2 x 2048 points (ladder 1024/512/256/128, where every scale pair
admits a window), from one table of seeded weights loaded into both.

Tolerances. Both sides compute in float32; their sums may run in other
orders (the fused BatchNorm's backward, the attention's and the
scatter-mean's), so they may part by rounding, and a feature-space search can
then flip a near-tied neighbour. The limits leave room for that and no more:
the window-mode tests also run the reference with its matrix products in
TF32 (``ops.tf32_matmuls``), the precision below float32, and that has to
fail the same limit.
"""

import json

import numpy as np
import pytest
import torch

from mpa_tpu_torch.configs import PRESETS, model_kwargs
from mpa_tpu_torch.data.s3dis import block_features as program_block_features
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.nn.window_mode import spec_or_none
from mpa_tpu_torch.train import TRAIN_STEPS, create_train_state
from portbench import weights
from portbench.conftest import ROOT
from portbench.configs import markov_semseg_s3dis_window_all as cfg
from portbench.reference import ops
from portbench.reference import train as rtrain
from portbench.reference import window_ops
from portbench.reference.layers import calibrate, weight_table
from portbench.traffic import s3dis_rooms

# The suite's workers share the cores: one torch thread a process.
torch.set_num_threads(1)

CPU = torch.device("cpu")
PRESET = "s3dis_semseg_window_all"
N = 2048
SIZES = json.loads((ROOT / "portbench/configs/markov_semseg_s3dis_window_all.json").read_text())
# The served log-probs: the largest gap at any point (TF32 reads about 2.8).
LOGP_GAP = 1e-4
# One train step: the loss's gap over the loss (0 on the CPU, TF32 3e-3),
# and each leaf's largest gradient gap over the larger of that leaf's and
# the median leaf's largest gradient (4e-4 on the CPU, TF32 above 1).
LOSS_GAP = 1e-5
GRAD_GAP = 2e-3


def _blocks(seed=11):
    data = s3dis_rooms.make(2, N, seed, {})
    return torch.from_numpy(data["points"]), torch.from_numpy(data["labels"])


def _pair(mode):
    """The reference and the program's model in ``mode``, one table of
    weights from the seed in both."""
    sizes = dict(SIZES, num_points=N, npoints=[N >> (i + 1) for i in range(4)],
                 neighbor_mode=mode)
    ref = cfg.reference(sizes)
    ref.load_state_dict(weights.make(weight_table(ref), 1234, CPU))
    config = PRESETS[PRESET].with_overrides(num_points=N, batch_size=2, seed=77,
                                            neighbor_mode=mode)
    return ref, config, get_model(config.model, **model_kwargs(config))


@pytest.fixture(scope="module")
def served():
    """Blocks and a table of weights whose running statistics are the
    window-mode reference's batch statistics on them (a trained model's
    statistics keep the activations at the inputs' scale)."""
    points, _ = _blocks()
    ref, _, _ = _pair("window_all")
    calibrate(ref, lambda: ref(points))
    return points, {k: v.clone() for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("mode", ["window_all", "exact"])
def test_eval_forward_matches_the_reference(mode, served):
    points, wts = served
    ref, _, prog = _pair(mode)
    ref.load_state_dict(wts)
    weights.load_into_program(prog, wts)
    with torch.no_grad():
        want = ref.eval()(points)
        got = prog.eval()(points)
    assert got.shape == (2, N, 13)
    assert float((got - want).abs().max()) < LOGP_GAP
    assert cfg.compare_answers(got, want)["logp_far_share"] == 0.0
    if mode == "window_all":
        with torch.no_grad(), ops.tf32_matmuls():
            assert float((ref(points) - want).abs().max()) > LOGP_GAP


def _leaf_gap(got, want):
    median = float(np.median([float(g.abs().max()) for g in want.values()]))
    return max(float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), median)
               for n in want)


def _reference_step(ref, points, labels, tf32=False):
    """The reference's first step as ``rtrain.follow`` takes it: its loss
    and each leaf's gradient (no L2 term)."""
    ref.train()
    for p in ref.parameters():
        p.grad = None
    generator = torch.Generator().manual_seed(77)  # the dropout's, as the program's state
    scope = ops.tf32_matmuls() if tf32 else torch.enable_grad()
    with scope:
        loss = rtrain.smooth_nll(ref(points, generator), labels, SIZES["optimizer"]["smoothing"])
        loss.backward()
    return float(loss.detach()), {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                                  for n, p in ref.named_parameters()}


def test_one_train_step_matches_the_reference():
    points, labels = _blocks(12)
    ref, config, prog = _pair("window_all")
    wts = {k: v.clone() for k, v in ref.state_dict().items()}
    weights.load_into_program(prog, wts)
    state = create_train_state(prog, config, CPU)
    loss = float(TRAIN_STEPS["semseg"](config, 2)(state, points, labels))
    got = {n: p.grad.detach().clone() for n, p in prog.named_parameters()}
    want_loss, want = _reference_step(ref, points, labels)
    assert abs(loss - want_loss) / abs(want_loss) < LOSS_GAP
    assert set(got) == set(want) and _leaf_gap(got, want) < GRAD_GAP
    ref.load_state_dict(wts)
    low_loss, low = _reference_step(ref, points, labels, tf32=True)
    assert abs(low_loss - want_loss) / abs(want_loss) > LOSS_GAP
    assert _leaf_gap(low, want) > GRAD_GAP


def test_every_pair_of_the_cells_ladder_admits_a_window():
    config = PRESETS[PRESET]
    ladder = [config.num_points] + list(model_kwargs(config)["npoints"])
    assert ladder == [16384, 8192, 4096, 2048, 1024]
    for i, S in enumerate(ladder):
        for n_fine in ladder[:i + 1]:
            spec, ref = spec_or_none(S, n_fine), window_ops.window_spec(S, n_fine)
            assert spec is not None and ref is not None, (S, n_fine)
            assert (spec.sq, spec.bn, spec.n_chunks, spec.window) == (ref.sq, ref.bn, ref.n,
                                                                      ref.window)
            assert torch.equal(spec.window_start(), ref.starts())


def test_the_reference_search_stays_in_its_windows():
    points, _ = _blocks()
    xyz = points[..., :3][:, window_ops.morton_order(points[..., :3])[0]]
    spec = window_ops.window_spec(N // 2, N)
    idx = window_ops.windowed_knn(8, xyz, xyz[:, ::2].contiguous(), spec)
    assert idx.shape == (2, N // 2, 8) and window_ops.in_window(idx, spec)


def test_the_generator_gives_s3dis_blocks_from_the_seed():
    a, b = s3dis_rooms.make(3, 256, 2**31 + 5, {}), s3dis_rooms.make(3, 256, 2**31 + 5, {})
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["points"].shape == (3, 256, 9) and a["points"].dtype == np.float32
    assert a["labels"].min() >= 0 and a["labels"].max() < 13
    rooms = [s3dis_rooms.room(np.random.default_rng(seed))[0] for seed in (5, 6)]
    assert rooms[0].shape != rooms[1].shape or not np.array_equal(*rooms)
    rng = np.random.default_rng(0)
    room = rng.uniform(0, 255, (50, 6)).astype(np.float32)
    lo, hi, centre = room[:, :3].min(0), room[:, :3].max(0), room[3, :2]
    np.testing.assert_array_equal(s3dis_rooms.block_features(room, lo, hi, centre),
                                  program_block_features(room, lo, hi, centre))
