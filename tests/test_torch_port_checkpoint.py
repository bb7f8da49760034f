"""Port, the checkpointer and the eval entry point: ``train/checkpoint.py``
(save and restore, weights only across optimizers, the best metric kept,
the crash fallbacks, and the refusals: another architecture, a dtype,
missing BatchNorm statistics), then ``cli.train`` and ``cli.eval
--checkpoint`` on a ModelNet tree the test writes, on the CPU, and the
eval's accuracies with one vote against ``mpa_tpu``'s eval step and metrics
on the same weights and data.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import SMALL, _nest, _x, state_to_flax  # noqa: E402
from test_torch_port_data import _shapenet_tree  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.data.modelnet import load_modelnet as jax_load_modelnet  # noqa: E402
from mpa_tpu.data.shapenetpart import SEG_PARTS as JAX_SEG_PARTS  # noqa: E402
from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.train import metrics as jax_metrics  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import eval as cli_eval  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS  # noqa: E402
from mpa_tpu_torch.data import synthetic_clouds  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier  # noqa: E402
from mpa_tpu_torch.train import (  # noqa: E402
    BestCheckpointer,
    TrainState,
    create_train_state,
    make_cls_train_step,
    make_eval_step,
    make_optimizer,
)
from mpa_tpu_torch.utils.init import init_like_flax  # noqa: E402

CPU = torch.device("cpu")
CFG = PRESETS["scanobjectnn_cls"].with_overrides(label_smoothing=0.1)


def _model(seed, **kw):
    model = MarkovClassifier(num_classes=15, dropout=0.0, **{**SMALL, **kw})
    return init_like_flax(model, torch.Generator().manual_seed(seed))


def _trained(steps=2, seed=0):
    """A small classifier after ``steps`` adam-l2 steps, and a test batch."""
    state = create_train_state(_model(seed), CFG, CPU)
    step = make_cls_train_step(CFG, 8)
    for i in range(steps):
        x = torch.from_numpy(_x(50 + i, (4, 128, 3)))
        step(state, x, torch.from_numpy(np.arange(4) + i))
    return state, torch.from_numpy(_x(60, (3, 128, 3)))


def _logp(state, x):
    return make_eval_step()(state, x)


def test_save_and_restore_round_trip(tmp_path):
    state, x = _trained()
    ckpt = BestCheckpointer(tmp_path)
    assert ckpt.restore(state) is None  # nothing saved yet
    assert ckpt.save_if_best(state, 0.25)
    assert sorted(os.listdir(tmp_path)) == ["best"]
    fresh = create_train_state(_model(seed=1), CFG, CPU)
    assert not torch.equal(fresh.model.fc1.weight, state.model.fc1.weight)
    restored, metric = BestCheckpointer(tmp_path).restore(fresh)
    assert restored is fresh and metric == 0.25 and fresh.step == state.step == 2
    want, got = state.model.state_dict(), fresh.model.state_dict()
    assert set(got) == set(want)
    assert any(k.endswith("running_var") for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    want_opt, got_opt = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert got_opt["param_groups"] == want_opt["param_groups"]
    for i, s in want_opt["state"].items():
        for name, v in s.items():
            assert torch.equal(got_opt["state"][i][name], v), (i, name)
    torch.testing.assert_close(_logp(fresh, x), _logp(state, x), rtol=0, atol=0)
    # The next step is the same step from either state.
    step = make_cls_train_step(CFG, 8)
    y = torch.tensor([1, 2, 3])
    torch.testing.assert_close(step(fresh, x, y), step(state, x, y), rtol=0, atol=0)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def test_weights_only_restore_puts_adam_into_an_sgd_eval_state(tmp_path):
    state, x = _trained()
    BestCheckpointer(tmp_path).save_if_best(state, 0.5)
    model = _model(seed=3)
    eval_state = TrainState(model, make_optimizer("sgd", model.parameters(), 0.0))
    with pytest.raises(ValueError, match="optimizer Adam where the state has SGD"):
        BestCheckpointer(tmp_path).restore(eval_state)
    _, metric = BestCheckpointer(tmp_path).restore(eval_state, restore_optimizer=False)
    assert metric == 0.5 and eval_state.step == 2
    assert eval_state.optimizer.state_dict()["state"] == {}
    torch.testing.assert_close(_logp(eval_state, x), _logp(state, x), rtol=0, atol=0)


def test_save_if_best_keeps_the_maximum(tmp_path):
    state, _ = _trained(steps=1)
    ckpt = BestCheckpointer(tmp_path)
    assert ckpt.save_if_best(state, 0.5)
    assert not ckpt.save_if_best(state, 0.3)
    assert not ckpt.save_if_best(state, 0.5)
    state.step = 7
    assert ckpt.save_if_best(state, 0.7) and ckpt.best_metric == 0.7
    again = BestCheckpointer(tmp_path)
    fresh = create_train_state(_model(seed=1), CFG, CPU)
    assert again.restore(fresh)[1] == 0.7 and fresh.step == 7
    assert not again.save_if_best(state, 0.6)


def _two_checkpoints(tmp_path):
    """``best`` files of metric 0.5 (step 1) and 0.7 (step 2), apart."""
    state, _ = _trained(steps=1)
    ckpt = BestCheckpointer(tmp_path / "a")
    ckpt.save_if_best(state, 0.5)
    shutil.copy(ckpt.path, tmp_path / "old")
    state.step = 2
    ckpt.save_if_best(state, 0.7)
    shutil.copy(ckpt.path, tmp_path / "new")
    return tmp_path / "old", tmp_path / "new"


@pytest.mark.parametrize("left,want", [
    ({"best.old": "old", "best.new": "new"}, (0.7, 2)),  # crash before the new one moved in
    ({"best.old": "old"}, (0.5, 1)),
    ({"best.new": "new"}, (0.7, 2)),
    ({"best": "old", "best.new": "new"}, (0.5, 1)),  # crash before the swap: best is whole
])
def test_restore_falls_back_after_a_crash(tmp_path, left, want):
    old, new = _two_checkpoints(tmp_path)
    directory = tmp_path / "ckpt"
    directory.mkdir()
    for name, src in left.items():
        shutil.copy({"old": old, "new": new}[src], directory / name)
    state = create_train_state(_model(seed=1), CFG, CPU)
    _, metric = BestCheckpointer(directory).restore(state)
    assert (metric, state.step) == want
    assert (directory / "best").exists()


def _saved_payload(tmp_path):
    state, _ = _trained(steps=1)
    ckpt = BestCheckpointer(tmp_path)
    ckpt.save_if_best(state, 0.5)
    return ckpt, torch.load(ckpt.path, weights_only=True)


@pytest.mark.parametrize("fault,match", [
    ("float64", r"keep_high\.la0\..* has dtype torch\.float64 where the model has torch\.float32"),
    ("no_batchnorm", r"BatchNorm statistics missing: \["),
    ("extra_batchnorm", r"BatchNorm statistics extra: \['ghost\.running_mean'\]"),
    ("missing_key", r"missing model entries \['fc3\.weight'\]"),
])
def test_restore_refuses_a_mismatched_checkpoint(tmp_path, fault, match):
    ckpt, payload = _saved_payload(tmp_path)
    model = payload["model"]
    if fault == "float64":
        key = next(k for k in model if k.startswith("keep_high.la0.") and k.endswith("weight"))
        model[key] = model[key].double()
    elif fault == "no_batchnorm":
        for k in [k for k in model if k.rsplit(".", 1)[-1] in
                  ("running_mean", "running_var", "num_batches_tracked")]:
            del model[k]
    elif fault == "extra_batchnorm":
        model["ghost.running_mean"] = torch.zeros(4)
    else:
        del model["fc3.weight"]
    torch.save(payload, ckpt.path)
    state = create_train_state(_model(seed=1), CFG, CPU)
    with pytest.raises(ValueError, match=match):
        BestCheckpointer(tmp_path).restore(state, restore_optimizer=False)


@pytest.mark.parametrize("other", [dict(num_classes=40), dict(channels=(16, 16, 16, 32, 32, 32))])
def test_restore_refuses_another_architecture(tmp_path, other):
    ckpt, _ = _saved_payload(tmp_path)
    model = MarkovClassifier(**{"num_classes": 15, **SMALL, **other})
    state = TrainState(model, make_optimizer("sgd", model.parameters(), 0.0))
    with pytest.raises(ValueError, match="has shape .* a different model configuration"):
        BestCheckpointer(tmp_path).restore(state, restore_optimizer=False)


# -- cli.train, then cli.eval --checkpoint ---------------------------------------------------


@pytest.fixture(scope="module")
def modelnet_root(tmp_path_factory):
    """A 2-class ModelNet40 tree of ``synthetic_clouds`` (1100 rows of
    comma-separated xyz + normal a shape): 8 train and 4 test shapes."""
    root = tmp_path_factory.mktemp("modelnet")
    names = ["airplane", "bed"]
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    pts, labels = synthetic_clouds(12, 1100, 2, seed=5)
    normals = np.random.default_rng(6).standard_normal(pts.shape).astype(np.float32)
    ids = []
    for name in names:
        (root / name).mkdir()
    for i, (p, n, c) in enumerate(zip(pts, normals, labels)):
        sid = f"{names[c]}_{i:04d}"
        np.savetxt(root / names[c] / f"{sid}.txt", np.concatenate([p, n], -1), fmt="%.6f",
                   delimiter=",")
        ids.append(sid)
    (root / "modelnet40_train.txt").write_text("\n".join(ids[:8]) + "\n")
    (root / "modelnet40_test.txt").write_text("\n".join(ids[8:]) + "\n")
    return str(root)


def _train_argv(root, log_dir):
    return ["--preset", "modelnet40_cls", "--dataset", "modelnet40", "--data_root", root,
            "--log_dir", log_dir, "--device", "cpu", "--batch_size", "4", "--max_steps", "2",
            "--num_votes", "2", "--seed", "0"]


def _eval_argv(root, log_dir, votes, repeats=1):
    return ["--preset", "modelnet40_cls", "--dataset", "modelnet40", "--data_root", root,
            "--checkpoint", os.path.join(log_dir, "modelnet40_cls_modelnet40", "checkpoints"),
            "--num_votes", str(votes), "--num_repeat", str(repeats), "--batch_size", "4",
            "--device", "cpu", "--log_dir", log_dir]


def test_cli_train_then_cli_eval_on_cpu(modelnet_root, tmp_path, capsys):
    kernels.reset_launch_counts()
    log_dir = str(tmp_path)
    out = cli_train.main(_train_argv(modelnet_root, log_dir))
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all() and out["aug_delta"] is None
    assert {"instance_acc", "single_acc", "class_acc"} <= set(out)
    log = capsys.readouterr().out
    assert "num_classes=40" in log and "(2 votes): vote-acc" in log and "over 4 clouds" in log
    assert os.path.exists(os.path.join(log_dir, "modelnet40_cls_modelnet40", "checkpoints", "best"))

    res = cli_eval.main(_eval_argv(modelnet_root, log_dir, votes=2, repeats=2))
    for k in ("vote_acc", "single_acc", "class_acc"):
        assert 0.0 <= res[k] <= 1.0, k
    assert res["clouds"] == 4 and len(res["pass_seconds"]) == 2
    log = capsys.readouterr().out
    assert "loaded" in log and "(step 2," in log and "BEST of 2: vote-acc" in log
    report = os.path.join(log_dir, "eval_modelnet40_cls_modelnet40", "eval.txt")
    assert open(report).read().splitlines()[-1].startswith("BEST of 2: vote-acc")
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only

    fresh = cli_eval.main(_eval_argv(modelnet_root, log_dir, votes=1)[:6] + [
        "--num_votes", "1", "--batch_size", "4", "--device", "cpu", "--log_dir", log_dir])
    assert "evaluating a fresh init" in capsys.readouterr().out and 0 <= fresh["vote_acc"] <= 1
    with pytest.raises(SystemExit, match="no checkpoint under"):
        cli_eval.main(_eval_argv(modelnet_root, str(tmp_path / "none"), votes=1))


def test_cli_train_evaluates_from_min_val_epoch(modelnet_root, tmp_path, capsys):
    out = cli_train.main(_train_argv(modelnet_root, str(tmp_path)) + ["--min_val_epoch", "1"])
    assert out["steps"] == 2 and "instance_acc" not in out  # epoch 0: no eval, no checkpoint
    assert "eval after" not in capsys.readouterr().out
    assert not os.path.exists(os.path.join(tmp_path, "modelnet40_cls_modelnet40", "checkpoints",
                                           "best"))
    cfg = cli_train.config_from_args(cli_train.parse_args(["--aug_scale", "--num_votes", "5"]))
    assert (cfg.aug_scale, cfg.aug_shift, cfg.num_votes) == (True, False, 5)
    assert cli_train.augmentation(cfg) == (True, False)
    assert cli_train.augmentation(PRESETS["shapenetpart"].with_overrides(aug_scale=False)) == (
        True, True)


def test_cli_eval_partseg_protocol_on_cpu(tmp_path, capsys):
    """``cli.train`` one part-seg step on a ShapeNetPart tree, then
    ``cli.eval``: one vote pass, the category-masked argmax and the
    reference's eval.txt lines, whose numbers are ``mpa_tpu``'s metrics on
    the same pool; ``--replicate_argmax_quirk`` compares category-local
    labels."""
    root = _shapenet_tree(tmp_path / "data")
    log_dir = str(tmp_path / "runs")
    argv = ["--preset", "shapenetpart", "--dataset", "shapenetpart", "--data_root", root,
            "--log_dir", log_dir, "--device", "cpu", "--batch_size", "2"]
    out = cli_train.main(argv + ["--max_steps", "1", "--seed", "0"])
    assert out["steps"] == 1 and out["aug_delta"] > 0 and 0 <= out["ins_miou"] <= 1
    ckpt = os.path.join(log_dir, "shapenetpart_shapenetpart", "checkpoints")
    res = cli_eval.main(argv + ["--checkpoint", ckpt, "--num_votes", "2"])
    lines = open(os.path.join(log_dir, "eval_shapenetpart_shapenetpart", "eval.txt")).read()
    lines = lines.splitlines()
    assert [ln.split()[3] for ln in lines[:2]] == ["Airplane", "Chair"]
    assert lines[2:] == [f"Accuracy is: {res['point_acc']:.5f}",
                         f"Class avg accuracy is: {res['class_acc']:.5f}",
                         f"Class avg mIOU is: {res['class_miou']:.5f}",
                         f"Inctance avg mIOU is: {res['ins_miou']:.5f}"]
    capsys.readouterr()

    cfg = cli_train.config_from_args(cli_train.parse_args(argv))
    _, test = cli_train.load_dataset(cfg)
    state = cli_eval.eval_state(cfg, CPU)
    BestCheckpointer(ckpt).restore(state, restore_optimizer=False)
    generator = torch.Generator().manual_seed(cli_eval.PARTSEG_VOTE_SEED)
    pool, _ = cli_train.vote_pass(cfg, state, test, CPU, 2, generator)
    _, cats, segs = test
    preds = list(jax_metrics.category_masked_argmax(pool, cats, JAX_SEG_PARTS))
    ins, cls_m, _ = jax_metrics.part_iou_metrics(preds, list(segs), list(cats), JAX_SEG_PARTS)
    assert (res["ins_miou"], res["class_miou"]) == (ins, cls_m)
    assert res["point_acc"] == jax_metrics.point_accuracy(preds, list(segs))
    assert res["class_acc"] == jax_metrics.class_avg_point_accuracy(preds, list(segs),
                                                                     JAX_SEG_PARTS)
    quirk = cli_eval.main(argv + ["--checkpoint", ckpt, "--num_votes", "2",
                                  "--replicate_argmax_quirk"])
    local = list(jax_metrics.category_masked_argmax(pool, cats, JAX_SEG_PARTS,
                                                    replicate_offset_quirk=True))
    assert quirk["point_acc"] == jax_metrics.point_accuracy(local, list(segs))


def test_cli_eval_defaults_to_cuda(monkeypatch, modelnet_root, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli_eval.main(_eval_argv(modelnet_root, str(tmp_path), votes=1)[:-4])


def test_one_vote_eval_matches_mpa_tpu(modelnet_root, tmp_path):
    """``cli.eval --num_votes 1`` against ``mpa_tpu``'s eval step and
    metrics, on the checkpoint's weights converted to flax variables and the
    test split as ``mpa_tpu`` loads it."""
    log_dir = str(tmp_path)
    cli_train.main(_train_argv(modelnet_root, log_dir))
    res = cli_eval.main(_eval_argv(modelnet_root, log_dir, votes=1))

    ckpt = os.path.join(log_dir, "modelnet40_cls_modelnet40", "checkpoints", "best")
    state = {k: v for k, v in torch.load(ckpt, weights_only=True)["model"].items()}
    nested = _nest(state_to_flax(state))
    pts, labels, _ = jax_load_modelnet(modelnet_root, "test", 40, 1024)
    jm = JaxMarkovClassifier(num_classes=40)
    jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"],
                                   tx=jtr.make_optimizer("sgd", 0.0),
                                   batch_stats=nested["batch_stats"])
    logp = np.asarray(jax.jit(jtr.make_eval_step())(jstate, jnp.asarray(pts)))
    pred = logp.argmax(-1)
    assert res["vote_acc"] == jtr.instance_accuracy(pred, labels) == res["single_acc"]
    assert res["class_acc"] == jtr.class_average_accuracy(pred, labels, 40)
