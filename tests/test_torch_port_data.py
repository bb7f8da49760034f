"""Port parity, the real-data loaders: ``load_scanobjectnn``,
``load_modelnet`` (cached and not, offline FPS or the head rows, the cache
shared with ``mpa_tpu`` both ways) and ``load_split`` against ``mpa_tpu``'s
on data trees the test writes in the published on-disk formats;
``native_io`` against ``mpa_tpu``'s and its numpy fallback, and its build
directory; ``subsample_points``; ``cli.train --dry_data_check``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (one torch thread a worker)

from mpa_tpu.data import native_io as jax_native_io  # noqa: E402
from mpa_tpu.data.modelnet import load_modelnet as jax_load_modelnet  # noqa: E402
from mpa_tpu.data.scanobjectnn import load_scanobjectnn as jax_load_scanobjectnn  # noqa: E402
from mpa_tpu.data.shapenetpart import load_split as jax_load_split  # noqa: E402
from mpa_tpu.ops.sampling import subsample_points as jax_subsample_points  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.data import load_modelnet, load_scanobjectnn, load_split, native_io  # noqa: E402
from mpa_tpu_torch.data.shapenetpart import SEG_CLASSES  # noqa: E402
from mpa_tpu_torch.ops import subsample_points  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


# -- data trees in the published formats (the layout of tests/test_data_loaders.py) ----------


@pytest.fixture(scope="module")
def scanobjectnn_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scanobjectnn")
    r = np.random.default_rng(0)
    d = root / "main_split"
    d.mkdir()
    for split, m in [("training", 12), ("test", 6)]:
        with h5py.File(d / f"{split}_objectdataset_augmentedrot_scale75.h5", "w") as f:
            f["data"] = r.normal(size=(m, 2048, 3)).astype(np.float32)
            f["label"] = r.integers(0, 15, size=(m,))
    return str(root)


def _modelnet_tree(root):
    root.mkdir(exist_ok=True)
    r = np.random.default_rng(1)
    names = ["airplane", "bed"]
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    ids = []
    for name in names:
        (root / name).mkdir()
        for i in range(3):
            sid = f"{name}_{i:04d}"
            arr = r.normal(size=(300, 6)).astype(np.float32)
            np.savetxt(root / name / f"{sid}.txt", arr, fmt="%.6f", delimiter=",")
            ids.append(sid)
    (root / "modelnet40_train.txt").write_text("\n".join(ids) + "\n")
    (root / "modelnet40_test.txt").write_text("\n".join(ids[:2]) + "\n")
    return str(root)


@pytest.fixture
def modelnet_root(tmp_path):
    return _modelnet_tree(tmp_path)


def _shapenet_tree(root, bad_label=False):
    root.mkdir(exist_ok=True)
    r = np.random.default_rng(2)
    cats = {"Airplane": "02691156", "Chair": "03001627"}
    with open(root / "synsetoffset2category.txt", "w") as f:
        for name, syn in cats.items():
            f.write(f"{name}\t{syn}\n")
    (root / "train_test_split").mkdir()
    files = {"train": [], "val": [], "test": []}
    for name, syn in cats.items():
        (root / syn).mkdir()
        for i in range(3):
            uid = f"uuid{name}{i}"
            n = int(r.integers(150, 400))
            parts = r.choice(SEG_CLASSES[name], size=n)
            if bad_label and name == "Airplane" and i == 0:
                parts[:20] = SEG_CLASSES["Chair"][0]  # Chair parts in an Airplane
            arr = np.column_stack([r.normal(size=(n, 6)), parts])
            np.savetxt(root / syn / f"{uid}.txt", arr, fmt="%.6f")
            files[["train", "val", "test"][i % 3]].append(f"shape_data/{syn}/{uid}")
    for split, lst in files.items():
        with open(root / "train_test_split" / f"shuffled_{split}_file_list.json", "w") as f:
            json.dump(lst, f)
    return str(root)


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    return _shapenet_tree(tmp_path_factory.mktemp("shapenetpart"))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, w)


# -- the loaders against mpa_tpu's --------------------------------------------------------------


@pytest.mark.parametrize("split", ["training", "test"])
def test_load_scanobjectnn_matches(scanobjectnn_root, split):
    got = load_scanobjectnn(scanobjectnn_root, split)
    _equal(got, jax_load_scanobjectnn(scanobjectnn_root, split))
    assert got[0].shape[1:] == (2048, 3) and got[0].dtype == np.float32


@pytest.mark.parametrize("use_fps", [False, True])
@pytest.mark.parametrize("use_normals", [False, True])
def test_load_modelnet_uncached_matches(modelnet_root, use_fps, use_normals):
    kw = dict(num_point=128, use_normals=use_normals, use_fps=use_fps, cache=False)
    got = load_modelnet(modelnet_root, "train", 40, **kw)
    _equal(got[:2], jax_load_modelnet(modelnet_root, "train", 40, **kw)[:2])
    assert got[2] == ["airplane", "bed"] and got[0].shape == (6, 128, 6 if use_normals else 3)
    assert not [p for p in os.listdir(modelnet_root) if p.endswith(".npz")]


@pytest.mark.parametrize("use_fps", [False, True])
def test_load_modelnet_cached_matches_and_is_reused(modelnet_root, use_fps, monkeypatch):
    kw = dict(num_point=64, use_fps=use_fps)
    first = load_modelnet(modelnet_root, "test", 40, **kw)
    _equal(first[:2], jax_load_modelnet(modelnet_root, "test", 40, cache=False, **kw)[:2])
    (cache,) = [p for p in os.listdir(modelnet_root) if p.endswith(".npz")]
    assert cache == f"mpa_cache_mn40_test_64pts_{'fps' if use_fps else 'head'}_xyz_2.npz"
    monkeypatch.setattr(native_io, "loadtxt", None)  # a parse now would fail
    _equal(load_modelnet(modelnet_root, "test", 40, **kw), first)


def test_modelnet_cache_is_shared_both_ways(tmp_path, monkeypatch):
    """A cache that ``mpa_tpu`` wrote serves the port, and one the port wrote
    serves ``mpa_tpu``: neither parses a source file again."""
    a, b = _modelnet_tree(tmp_path / "a"), _modelnet_tree(tmp_path / "b")
    want_a = jax_load_modelnet(a, "train", 40, num_point=96, use_fps=True)
    want_b = load_modelnet(b, "train", 40, num_point=96, use_fps=True)
    _equal(want_a[:2], want_b[:2])
    with monkeypatch.context() as m:
        m.setattr(native_io, "loadtxt", None)
        _equal(load_modelnet(a, "train", 40, num_point=96, use_fps=True), want_a)
    with monkeypatch.context() as m:
        m.setattr(jax_native_io, "loadtxt", None)
        _equal(jax_load_modelnet(b, "train", 40, num_point=96, use_fps=True), want_b)


@pytest.mark.parametrize("split,use_normals", [("trainval", False), ("test", True)])
def test_load_split_matches(shapenet_root, split, use_normals):
    got = load_split(shapenet_root, split, 256, use_normals)
    _equal(got, jax_load_split(shapenet_root, split, 256, use_normals))
    assert got[0].shape == ((4 if split == "trainval" else 2), 256, 6 if use_normals else 3)


# -- native_io -----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def text_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clouds")
    r = np.random.default_rng(3)
    paths = []
    for i in range(3):
        p = tmp / f"f{i}.txt"
        np.savetxt(p, np.column_stack([r.normal(size=(500, 6)), r.integers(0, 50, 500)]),
                   fmt="%.6f")
        paths.append(str(p))
    comma = tmp / "comma.txt"
    np.savetxt(comma, r.normal(size=(100, 6)), fmt="%.6f", delimiter=",")
    return paths, str(comma)


def test_native_loadtxt_matches_mpa_tpu_and_the_fallback(text_files, monkeypatch):
    paths, comma = text_files
    assert native_io.native_available()
    got = [native_io.loadtxt(p, 7) for p in paths] + [native_io.loadtxt(comma, 6)]
    data, counts = native_io.loadtxt_many(paths, 7, max_rows=1024)
    _equal(got, [jax_native_io.loadtxt(p, 7) for p in paths] + [jax_native_io.loadtxt(comma, 6)])
    jdata, jcounts = jax_native_io.loadtxt_many(paths, 7, max_rows=1024)
    _equal([counts] + [d[:c] for d, c in zip(data, counts)],
           [jcounts] + [d[:c] for d, c in zip(jdata, jcounts)])  # rows past a count: unset
    monkeypatch.setattr(native_io, "_load", lambda: None)
    assert not native_io.native_available()
    _equal(got, [native_io.loadtxt(p, 7) for p in paths] + [native_io.loadtxt(comma, 6)])
    fdata, fcounts = native_io.loadtxt_many(paths, 7, max_rows=1024)
    _equal([fcounts] + [d[:c] for d, c in zip(fdata, fcounts)],
           [counts] + [d[:c] for d, c in zip(data, counts)])


def test_native_fps_matches_mpa_tpu_and_the_fallback(monkeypatch):
    pts = np.random.default_rng(4).normal(size=(3, 400, 6)).astype(np.float32)
    counts = np.array([400, 350, 200])
    got = [native_io.fps_indices(p, 64) for p in pts]
    many = native_io.fps_indices_many(pts, counts, 64)
    _equal(got, [jax_native_io.fps_indices(p, 64) for p in pts])
    _equal([many], [jax_native_io.fps_indices_many(pts, counts, 64)])
    _equal(got, [native_io._fps_numpy(p, 64) for p in pts])
    monkeypatch.setattr(native_io, "_load", lambda: None)
    _equal([native_io.fps_indices_many(pts, counts, 64)], [many])


def test_native_library_builds_into_the_ports_own_directory(tmp_path, monkeypatch):
    assert Path(native_io._BUILD_DIR) == REPO / "mpa_tpu_torch" / "kernels" / "_build"
    assert "mpa_tpu_torch/kernels/_build/" in (REPO / ".gitignore").read_text().splitlines()
    native_build = REPO / "native" / "build"
    assert jax_native_io.native_available()  # mpa_tpu's own library, built where it builds it
    so = native_build / "libpointio.so"
    deadline = time.time() + 10  # let a build by another test process finish
    while time.time() - so.stat().st_mtime < 2 and time.time() < deadline:
        time.sleep(0.2)

    def listing():
        return {p.name: p.stat().st_mtime_ns for p in native_build.iterdir()}

    before = listing()
    monkeypatch.setattr(native_io, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_io, "_lib", None)
    assert native_io.native_available()
    assert sorted(os.listdir(tmp_path)) == ["libpointio.so"]
    assert listing() == before


# -- subsample_points ------------------------------------------------------------------------------


def test_subsample_points():
    x = np.random.default_rng(5).normal(size=(4, 100, 3)).astype(np.float32)
    np.testing.assert_array_equal(subsample_points(torch.from_numpy(x), 40).numpy(),
                                  np.asarray(jax_subsample_points(x, 40)))
    a = subsample_points(torch.from_numpy(x), 40, generator=torch.Generator().manual_seed(1))
    b = subsample_points(torch.from_numpy(x), 40, generator=torch.Generator().manual_seed(1))
    assert a.shape == (4, 40, 3) and torch.equal(a, b)
    for cloud, sub in zip(x, a.numpy()):
        rows = {tuple(r) for r in cloud}
        assert all(tuple(r) in rows for r in sub) and len({tuple(r) for r in sub}) == 40
    assert not torch.equal(a[0], a[1]) and not torch.equal(a, torch.from_numpy(x[:, :40]))
    with pytest.raises(ValueError, match="without replacement"):
        subsample_points(torch.from_numpy(x), 101, generator=torch.Generator())


# -- --dry_data_check ------------------------------------------------------------------------------


def test_cli_train_on_scanobjectnn_takes_its_2048_points(scanobjectnn_root, tmp_path, capsys):
    out = cli_train.main(["--preset", "scanobjectnn_cls", "--dataset", "scanobjectnn",
                          "--data_root", scanobjectnn_root, "--log_dir", str(tmp_path),
                          "--device", "cpu", "--batch_size", "4", "--max_steps", "1",
                          "--num_votes", "1", "--eval_clouds", "4", "--seed", "0"])
    assert out["steps"] == 1 and np.isfinite(out["losses"]).all()
    assert "over 4 clouds" in capsys.readouterr().out
    cfg = cli_train.config_from_args(cli_train.parse_args(
        ["--dataset", "scanobjectnn", "--data_root", scanobjectnn_root]))
    train, test = cli_train.load_dataset(cfg, n_eval=4)
    assert train[0].shape == (12, 2048, 3) and test[0].shape == (4, 2048, 3)


def test_dry_data_check_reports_ok(modelnet_root, shapenet_root, scanobjectnn_root, capsys):
    assert cli_train.main(["--preset", "modelnet40_cls", "--dataset", "modelnet40",
                           "--data_root", modelnet_root, "--num_points", "128",
                           "--dry_data_check"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] and report["train"]["shapes"] == [[6, 128, 3], [6]]
    assert report["epoch_plan"]["steps_per_epoch"] == 1
    assert cli_train.main(["--preset", "shapenetpart", "--dataset", "shapenetpart",
                           "--data_root", shapenet_root, "--num_points", "256",
                           "--dry_data_check"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] and report["test"]["clouds"] == 2 and report["problems"] == []
    assert cli_train.main(["--dataset", "scanobjectnn", "--data_root", scanobjectnn_root,
                           "--dry_data_check"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] and report["train"]["shapes"] == [[12, 2048, 3], [12]]
    assert cli_train.main(["--preset", "shapenetpart", "--dataset", "modelnet40",
                           "--data_root", modelnet_root, "--dry_data_check"]) == 1
    assert "has no partseg data" in capsys.readouterr().out
    assert cli_train.main(["--dataset", "scanobjectnn", "--data_root", modelnet_root,
                           "--dry_data_check"]) == 1  # no h5 files there
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not report["ok"] and "objectdataset_augmentedrot_scale75.h5" in report["error"]


def test_dry_data_check_exits_1_on_a_label_outside_its_category(tmp_path):
    root = _shapenet_tree(tmp_path, bad_label=True)
    proc = subprocess.run(
        [sys.executable, "-m", "mpa_tpu_torch.cli.train", "--preset", "shapenetpart",
         "--dataset", "shapenetpart", "--data_root", root, "--num_points", "2048",
         "--dry_data_check"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not report["ok"]
    assert any("outside their cloud's category part block" in p for p in report["problems"])
