"""Port parity, the S3DIS scene path and the part-seg window modes served,
on the CPU: ``load_room`` and ``list_rooms`` on ``Area_*.npy`` rooms the
test writes, ``sliding_blocks`` yield for yield and ``scene_inference``
with one fixed numpy ``forward`` (its labels, and its warning on points no
block visits) against ``mpa_tpu/data/s3dis.py``, all bit for bit;
``cli.train --dataset s3dis`` (its blocks against ``mpa_tpu``'s
``load_dataset``, ``--dry_data_check`` and a two-step run); and
``load_segmenter(neighbor_mode="window" | "window_all")`` against
``mpa_tpu``'s ``markov_partseg`` in those modes, from the same weights.

Tolerances: the data functions are numpy on both sides and are held bit
for bit; the served log-probs within 1e-4, the bound of
``tests/test_torch_port_window.py``'s model test.
"""

import os
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import _nest, state_to_flax  # noqa: E402
from test_torch_port_pose_completion import jax_variables  # noqa: E402

import mpa_tpu.cli.train as jax_cli_train  # noqa: E402
from mpa_tpu.configs.presets import PRESETS as JAX_PRESETS  # noqa: E402
from mpa_tpu.data import s3dis as jax_s3dis  # noqa: E402
from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.data import s3dis  # noqa: E402
from mpa_tpu_torch.serve import load_segmenter, load_semantic_segmenter  # noqa: E402


def write_room(path: Path, n: int, seed: int, size=(2.0, 1.5, 2.5)) -> None:
    """One room file of ``[n, 7]`` rows: xyz uniform in a ``size`` box, rgb
    in [0, 255], the label from three height bands (``synthetic_semseg``'s
    rule)."""
    r = np.random.default_rng(seed)
    xyz = r.uniform(0.0, 1.0, (n, 3)) * np.asarray(size)
    rgb = r.uniform(0.0, 255.0, (n, 3))
    label = np.digitize(xyz[:, 2], [0.8, 1.7])
    np.save(path, np.column_stack([xyz, rgb, label]).astype(np.float32))


@pytest.fixture(scope="module")
def room_tree(tmp_path_factory):
    """Three training rooms (Areas 1, 2, 3), two test rooms (Area 5) and two
    files the lists must skip."""
    root = tmp_path_factory.mktemp("s3dis")
    for i, name in enumerate(["Area_1_office_1", "Area_2_hallway_1", "Area_3_office_2",
                              "Area_5_office_1", "Area_5_conferenceRoom_1"]):
        write_room(root / f"{name}.npy", 1500 + 300 * i, seed=i)
    np.save(root / "notes.npy", np.zeros((3, 7), np.float32))  # no "Area_": skipped
    (root / "Area_1_readme.txt").write_text("not a room\n")
    return root


def _equal(got, want):
    assert type(got) is type(want) or isinstance(got, np.ndarray)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


# -- rooms and blocks --------------------------------------------------------------------


@pytest.mark.parametrize("split,test_area", [("train", 5), ("test", 5), ("train", 2),
                                             ("test", 2), ("test", 4)])
def test_list_rooms_and_load_room_match_mpa_tpu(room_tree, split, test_area):
    got = s3dis.list_rooms(str(room_tree), test_area=test_area, split=split)
    want = jax_s3dis.list_rooms(str(room_tree), test_area=test_area, split=split)
    assert got == want
    for path in got:
        for g, w in zip(s3dis.load_room(path), jax_s3dis.load_room(path)):
            _equal(g, w)


@pytest.mark.parametrize("num_points,block_size,stride", [(4096, 1.0, 0.5), (512, 1.0, 0.5),
                                                         (300, 0.7, 0.35), (1000, 1.0, 1.0)])
def test_sliding_blocks_match_mpa_tpu(room_tree, num_points, block_size, stride):
    """Yield for yield: the same features and point indices in the same
    order, from the same ``default_rng(0)`` draws (shuffle, padding)."""
    xyzrgb, _ = s3dis.load_room(str(room_tree / "Area_1_office_1.npy"))
    got = list(s3dis.sliding_blocks(xyzrgb, num_points, block_size, stride))
    want = list(jax_s3dis.sliding_blocks(xyzrgb, num_points, block_size, stride))
    assert len(got) == len(want) > 1
    for (gf, gi), (wf, wi) in zip(got, want):
        _equal(gf, wf)
        _equal(gi, wi)
    visited = np.unique(np.concatenate([i for _, i in got]))
    assert len(visited) == len(xyzrgb)  # every point, at these strides


def _forward(seed):
    """A fixed numpy ``forward``: log-softmax of a random linear map of the
    9 features, ``[B, n, 9] -> [B, n, 13]``."""
    w = np.random.default_rng(seed).standard_normal((9, 13)).astype(np.float32)

    def forward(x):
        z = x @ w
        z = z - z.max(-1, keepdims=True)
        return z - np.log(np.exp(z).sum(-1, keepdims=True))

    return forward


@pytest.mark.parametrize("batch_size", [1, 3, 8])
def test_scene_inference_matches_mpa_tpu(room_tree, batch_size):
    """Labels bit for bit, the tail batch padded with copies that vote for
    no point (``batch_size`` 3 and 8 leave a ragged tail here)."""
    xyzrgb, _ = s3dis.load_room(str(room_tree / "Area_3_office_2.npy"))
    calls = []

    def counting(x):
        calls.append(x.shape)
        return _forward(1)(x)

    got = s3dis.scene_inference(counting, xyzrgb, num_points=512, batch_size=batch_size)
    want = jax_s3dis.scene_inference(_forward(1), xyzrgb, num_points=512, batch_size=batch_size)
    _equal(got, want)
    assert all(shape == (batch_size, 512, 9) for shape in calls)
    assert got.shape == (len(xyzrgb),) and got.min() >= 0 and got.max() < 13


def test_scene_inference_warns_on_unvisited_points(room_tree):
    """A stride wider than the block leaves gaps: both packages warn with the
    same count, and the unvisited points get class 0."""
    xyzrgb, _ = s3dis.load_room(str(room_tree / "Area_2_hallway_1.npy"))
    with pytest.warns(UserWarning, match="unvisited") as got_w:
        got = s3dis.scene_inference(_forward(2), xyzrgb, num_points=256, block_size=0.3,
                                    stride=0.9, batch_size=4)
    with pytest.warns(UserWarning, match="unvisited") as want_w:
        want = jax_s3dis.scene_inference(_forward(2), xyzrgb, num_points=256, block_size=0.3,
                                         stride=0.9, batch_size=4)
    _equal(got, want)
    assert str(got_w[0].message) == str(want_w[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the default stride visits every point: no warning
        s3dis.scene_inference(_forward(2), xyzrgb, num_points=256, batch_size=4)


# -- the training CLI on rooms ------------------------------------------------------------


def test_s3dis_dataset_matches_mpa_tpu(room_tree):
    """32 blocks a training room and 16 a test room, each room's drawn from
    ``default_rng(0)``, bit for bit ``mpa_tpu``'s ``load_dataset``."""
    kw = dict(dataset="s3dis", data_root=str(room_tree), num_points=512)
    got = cli_train.load_dataset(cli_train.PRESETS["s3dis_semseg"].with_overrides(**kw))
    want = jax_cli_train.load_dataset(JAX_PRESETS["s3dis_semseg"].with_overrides(**kw))
    for g_split, w_split in zip(got, want):
        for g, w in zip(g_split, w_split):
            _equal(g, w)
    assert got[0][0].shape == (3 * 32, 512, 9) and got[1][0].shape == (2 * 16, 512, 9)
    assert cli_train.S3DIS_BLOCKS == (32, 16)


def test_cli_train_s3dis_dry_data_check_and_two_steps(room_tree, tmp_path, capsys):
    data = ["--preset", "s3dis_semseg", "--dataset", "s3dis", "--data_root", str(room_tree),
            "--num_points", "256"]
    assert cli_train.main(data + ["--dry_data_check"]) == 0
    report = capsys.readouterr().out
    assert '"ok": true' in report and '"clouds": 96' in report and '"clouds": 32' in report
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli_train.main(["--preset", "s3dis_semseg", "--dataset", "s3dis", "--data_root",
                           str(empty), "--dry_data_check"]) == 1
    assert "no train rooms" in capsys.readouterr().out
    kernels.reset_launch_counts()
    out = cli_train.main(data + ["--device", "cpu", "--max_steps", "2", "--batch_size", "2",
                                 "--train_clouds", "4", "--eval_clouds", "2", "--seed", "0",
                                 "--log_dir", str(tmp_path / "runs")])
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["block_miou"] <= 1.0 and 0.0 <= out["point_acc"] <= 1.0
    assert (tmp_path / "runs" / "s3dis_semseg_s3dis" / "checkpoints").is_dir()
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}


def test_scene_inference_through_the_semantic_segmenter(room_tree):
    """The scene path end to end on the CPU: a written room through
    ``load_semantic_segmenter`` (256-point blocks), labels for every point,
    the same twice."""
    xyzrgb, _ = s3dis.load_room(str(room_tree / "Area_5_office_1.npy"))
    seg = load_semantic_segmenter(device="cpu", seed=0, num_points=256)
    forward = lambda x: seg(x).numpy()  # noqa: E731
    a = s3dis.scene_inference(forward, xyzrgb, num_points=256, batch_size=4)
    b = s3dis.scene_inference(forward, xyzrgb, num_points=256, batch_size=4)
    assert a.shape == (len(xyzrgb),) and a.min() >= 0 and a.max() < 13
    np.testing.assert_array_equal(a, b)


# -- the part-seg window modes, served -----------------------------------------------------


@pytest.mark.parametrize("mode", ["window", "window_all"])
def test_load_segmenter_window_modes_match_mpa_tpu(mode):
    """``load_segmenter(neighbor_mode=mode, num_points=256)`` at the preset's
    widths from ``mpa_tpu``'s variables: its log-probs within 1e-4 of
    ``mpa_tpu``'s ``markov_partseg`` in the same mode; the seeded segmenter's
    weights carried out and back unchanged; plain ops only on the CPU."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 256, 3)).astype(np.float32)
    cats = rng.integers(0, 16, 2)
    onehot = np.eye(16, dtype=np.float32)[cats]
    jm = JaxMarkovPartSeg(npoints=(128, 64, 32, 16), neighbor_mode=mode)
    flat = jax_variables(jm, (jnp.asarray(x), jnp.asarray(onehot)))
    want = np.asarray(jax.jit(lambda v, p, o: jm.apply(v, (p, o), train=False))(
        _nest(flat), jnp.asarray(x), jnp.asarray(onehot)))
    kernels.reset_launch_counts()
    seg = load_segmenter(variables=flat, device="cpu", neighbor_mode=mode, num_points=256)
    assert seg.model.keep_high.neighbor_mode == mode
    got = seg(x, cats).numpy()
    assert got.shape == (2, 256, 50) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}
    seeded = load_segmenter(device="cpu", seed=4, neighbor_mode=mode, num_points=256)
    again = load_segmenter(variables=state_to_flax(seeded.model.state_dict()), device="cpu",
                           neighbor_mode=mode, num_points=256)
    torch.testing.assert_close(again(x, cats), seeded(x, cats), rtol=0, atol=0)
