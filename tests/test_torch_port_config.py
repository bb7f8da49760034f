"""Port parity, the training config and its flags, on the CPU.

``mpa_tpu_torch.configs`` against ``mpa_tpu.utils.config``: every field
and default, the flags (explicit, abbreviated, boolean), the preset
resolution of ``resolve_config`` field for field, and the task-default
model resolution of ``mpa_tpu/cli/train.py`` run as its ``main`` runs it.
"""

import argparse
import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (one torch thread)

from mpa_tpu.configs import PRESETS as JAX_PRESETS  # noqa: E402
from mpa_tpu.utils import config as jax_config  # noqa: E402
from mpa_tpu_torch import configs  # noqa: E402
from mpa_tpu_torch.cli import eval as cli_eval  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402

# The port's own fields: part-seg's label counts, which mpa_tpu takes from
# its data module.
PORT_ONLY = {"num_parts", "num_categories"}
# Fields on which a port preset differs from mpa_tpu's by design: the port's
# presets train on synthetic clouds unless --dataset names a real set.
PRESET_DIFFS = {"dataset"}


def test_every_mpa_tpu_field_and_default():
    jax_fields = {f.name: f.default for f in dataclasses.fields(jax_config.TrainConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(configs.TrainConfig)}
    assert set(port_fields) - set(jax_fields) == PORT_ONLY
    assert set(jax_fields) <= set(port_fields)
    for name, default in jax_fields.items():
        assert port_fields[name] == default, name
    assert configs.TrainConfig().eta_min == 1e-3 == jax_config.TrainConfig().eta_min
    assert configs.TrainConfig().init == "" and configs.TrainConfig().steps_per_epoch is None


def _both(argv, preset=True):
    """(port config, mpa_tpu config) of one command line, each resolved by
    its own ``resolve_config`` over its own parser."""
    jp = argparse.ArgumentParser()
    jax_config.add_config_flags(jp, jax_config.TrainConfig())
    jp.add_argument("--preset", default=None)
    pp = argparse.ArgumentParser()
    configs.add_config_flags(pp)
    pp.add_argument("--preset", default=None)
    return (configs.resolve_config(pp, pp.parse_args(argv), argv),
            jax_config.resolve_config(jp, jp.parse_args(argv), argv))


def _same(got, want, skip=()):
    for f in dataclasses.fields(want):
        if f.name not in skip:
            assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("argv", [
    ["--preset", "shapenetpart", "--learning_rate", "0.05", "--batch_s", "8"],
    ["--preset", "scanobjectnn_cls", "--num_point", "512", "--aug_scale", "true",
     "--scheduler", "cos", "--eta_min", "1e-4", "--init", "zero"],
    ["--preset", "s3dis_semseg", "--neighbor_mode", "window_all", "--fps_min_band", "128",
     "--seed", "3", "--epochs", "2"],
    ["--preset", "pose_modelnet40", "--synthetic_train_clouds", "64", "--label_smoothing", "0"],
])
def test_resolve_config_over_a_preset_equals_mpa_tpu(argv):
    got, want = _both(argv)
    _same(got, want, PRESET_DIFFS)
    preset = configs.PRESETS[argv[1]]
    jax_preset = JAX_PRESETS[argv[1]]
    _same(preset, jax_preset, PRESET_DIFFS)  # the bases agree
    assert got.dataset == preset.dataset  # the port's base, not overridden


@pytest.mark.parametrize("argv", [
    ["--task", "partseg", "--batch_size", "4"],
    ["--num_classes", "40", "--momentum", "0.5", "--decay_step", "3", "--aug_shift", "1"],
])
def test_flags_without_a_preset_equal_mpa_tpu(argv):
    got, want = _both(argv)
    _same(got, want)


def test_boolean_flags_take_no_value_too():
    p = argparse.ArgumentParser()
    configs.add_config_flags(p)
    assert p.parse_args(["--aug_scale"]).aug_scale is True
    assert p.parse_args(["--aug_scale", "false"]).aug_scale is False
    assert p.parse_args([]).aug_scale is False
    assert p.parse_args(["--steps_per_epoch", "7"]).steps_per_epoch == 7
    assert not any(a.dest == "mesh_axes" for a in p._actions)  # code-level, as in mpa_tpu


@pytest.mark.parametrize("argv", [["--task", "partseg"], ["--task", "partseg", "--dataset",
                                                          "shapenetpart"],
                                  ["--task", "semseg"], ["--task", "semseg", "--dataset", "s3dis"],
                                  ["--task", "pose"], ["--task", "completion"],
                                  ["--task", "cls"], ["--task", "partseg", "--model",
                                                      "markov_partseg_fp"]])
def test_task_default_resolution_matches_mpa_tpu(argv, monkeypatch):
    """``mpa_tpu``'s ``cli.train.main`` resolves, then stops at its data
    check, which is stubbed to hand out the config."""
    from mpa_tpu.cli import train as jax_cli_train

    seen = {}
    monkeypatch.setattr(jax_cli_train, "dry_data_check",
                        lambda cfg: seen.setdefault("cfg", cfg) and 0)
    jax_cli_train.main(argv + ["--dry_data_check"])
    want = seen["cfg"]
    got = cli_train.parse_args(argv).config
    _same(got, want, PRESET_DIFFS if "--dataset" not in argv else ())
    assert cli_eval.parse_args(argv).config == got


def test_cli_flags_of_both_entry_points():
    train = cli_train.parse_args(["--init", "xavier", "--import_torch", "x.pth",
                                  "--trust_torch_pickle", "--scheduler", "cos",
                                  "--eta_min", "0.01", "--optimizer", "sgd", "--epochs", "9"])
    cfg = train.config
    assert (cfg.init, cfg.scheduler, cfg.eta_min, cfg.optimizer, cfg.epochs) == (
        "xavier", "cos", 0.01, "sgd", 9)
    assert train.import_torch == "x.pth" and train.trust_torch_pickle
    ev = cli_eval.parse_args(["--import_torch", "y.pth", "--preset", "shapenetpart"])
    assert ev.import_torch == "y.pth" and not ev.trust_torch_pickle
    assert ev.config.task == "partseg"
    for name in (f.name for f in dataclasses.fields(jax_config.TrainConfig)):
        if name != "mesh_axes":
            assert f"--{name}" in cli_train.build_parser()._option_string_actions, name
