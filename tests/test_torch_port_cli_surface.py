"""Port, the trainer's surface on the CPU: ``cli.train`` and ``cli.eval``
through their new flags.

- ``--init zero`` on ``scanobjectnn_cls`` writes ``train.log`` and
  ``train_metrics.jsonl`` (``mpa_tpu``'s names and record layout);
- ``--import_torch`` of a written reference-layout ``.pth`` starts from its
  weights (at learning rate 0 the trained parameters are the imported ones,
  bit for bit), and ``cli.eval --import_torch`` evaluates them;
- ``--scheduler cos --eta_min`` reaches the optimizer's learning rate, as
  ``mpa_tpu``'s cosine schedule gives it;
- under a one-rank ``gloo`` group joined from torchrun's environment the
  loop runs its data-parallel path and reads the losses a one-process run
  reads, and leaves no group behind.
"""

import json
import os
import socket
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (one torch thread)

import chip_smoke  # noqa: E402  (reference_checkpoint; imports torch only)
from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.cli import eval as cli_eval  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier  # noqa: E402
from mpa_tpu_torch.utils.torch_import import import_reference_checkpoint  # noqa: E402

TINY = ["--device", "cpu", "--batch_size", "4", "--train_clouds", "8", "--eval_clouds", "4",
        "--seed", "0"]


def test_init_zero_run_writes_the_log_and_the_metrics(tmp_path, capsys):
    kernels.reset_launch_counts()
    out = cli_train.main(["--preset", "scanobjectnn_cls", "--init", "zero", "--max_steps", "2",
                          "--log_dir", str(tmp_path), *TINY])
    assert out["steps"] == 2 and len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert len(out["epoch_seconds"]) == len(out["clouds_per_s"]) == 1
    run_dir = tmp_path / "scanobjectnn_cls_synthetic"
    log = (run_dir / "train.log").read_text()
    assert "re-initialised the weights with --init zero" in log
    assert "step 2 (epoch 0): loss" in log and "clouds/s" in log and "vote-acc" in log
    assert "step 2 (epoch 0): loss" in capsys.readouterr().out  # the console too
    records = [json.loads(line) for line in (run_dir / "train_metrics.jsonl").read_text()
               .splitlines()]
    assert [list(r)[:2] for r in records] == [["time", "step"]] * 2
    assert records[0]["step"] == 2 and records[0]["epoch"] == 0
    assert records[0]["train_loss"] == pytest.approx(np.mean(out["losses"]))
    assert {"instance_acc", "single_acc", "class_acc"} <= set(records[1])
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}  # CPU: plain ops only


def test_import_torch_starts_from_the_file_and_cli_eval_reads_it(tmp_path, monkeypatch):
    pth = tmp_path / "best_model.pth"
    sd = chip_smoke.reference_checkpoint("cls", MarkovClassifier(num_classes=15), seed=6)
    torch.save({"epoch": 3, "model_state_dict": sd}, pth)
    want = MarkovClassifier(num_classes=15)
    import_reference_checkpoint(str(pth), "cls", want)
    state, out = cli_train.run(cli_train.parse_args(
        ["--import_torch", str(pth), "--learning_rate", "0", "--max_steps", "1",
         "--min_val_epoch", "1", "--log_dir", str(tmp_path), *TINY]))
    assert out["steps"] == 1
    for name, p in want.named_parameters():
        assert torch.equal(state.model.get_parameter(name).detach(), p.detach()), name
    assert "imported torch checkpoint" in (
        tmp_path / "scanobjectnn_cls_synthetic" / "train.log").read_text()

    seen = {}
    original = cli_eval.eval_cls

    def recording(cfg, state, *args):
        seen["state"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        return original(cfg, state, *args)

    monkeypatch.setattr(cli_eval, "eval_cls", recording)
    # Four eval clouds: cli.eval reads the whole synthetic split (128 clouds).
    monkeypatch.setattr(cli_eval, "load_dataset",
                        lambda cfg: cli_train.load_dataset(cfg, n_train=1, n_eval=4))
    res = cli_eval.main(["--import_torch", str(pth), "--num_votes", "1", "--device", "cpu",
                         "--batch_size", "4", "--log_dir", str(tmp_path)])
    assert 0.0 <= res["vote_acc"] <= 1.0
    for key, value in want.state_dict().items():
        assert torch.equal(seen["state"][key], value), key
    assert "imported torch checkpoint" in (
        tmp_path / "eval_scanobjectnn_cls_synthetic" / "eval.log").read_text()


def test_cosine_schedule_flags_reach_the_optimizer(tmp_path):
    """Two epochs of one step each (4 clouds at batch 4): the second step's
    learning rate is the cosine schedule's at epoch 1 of 2, as ``mpa_tpu``
    computes it. ``--steps_per_epoch 7`` changes nothing: the schedule's
    epoch is derived from the data, as in ``mpa_tpu``."""
    lr, eta_min = 0.2, 0.05
    state, out = cli_train.run(cli_train.parse_args(
        ["--preset", "shapenetpart", "--num_points", "256", "--scheduler", "cos",
         "--learning_rate", str(lr), "--eta_min", str(eta_min), "--epochs", "2",
         "--steps_per_epoch", "7", "--min_val_epoch", "2", "--log_dir", str(tmp_path),
         "--device", "cpu", "--batch_size", "4", "--train_clouds", "4", "--eval_clouds", "2"]))
    assert out["steps"] == 2 and state.step == 2
    want = float(jtr.cosine_schedule(lr, 2, eta_min)(1))
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(want, rel=1e-6)
    assert want == pytest.approx((lr + eta_min) / 2, rel=1e-6)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_one_rank_torchrun_environment_runs_the_data_parallel_loop(tmp_path, monkeypatch):
    argv = ["--preset", "shapenetpart", "--num_points", "256", "--max_steps", "2",
            "--min_val_epoch", "1", "--device", "cpu", "--batch_size", "2", "--train_clouds",
            "4", "--eval_clouds", "2", "--seed", "0"]
    _, plain = cli_train.run(cli_train.parse_args(argv + ["--log_dir", str(tmp_path / "a")]))
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    joined = {}
    real_init = cli_train.parallel.init

    def init(*args, **kw):
        joined["device"] = real_init(*args, **kw)
        joined["backend"] = dist.get_backend()
        return joined["device"]

    monkeypatch.setattr(cli_train.parallel, "init", init)
    state, ddp = cli_train.run(cli_train.parse_args(argv + ["--log_dir", str(tmp_path / "b")]))
    assert joined == {"device": torch.device("cpu"), "backend": "gloo"}
    assert not dist.is_initialized()
    assert all(m.process_group is not None for m in state.model.modules()
               if hasattr(m, "process_group"))
    np.testing.assert_allclose(ddp["losses"], plain["losses"], rtol=1e-5)
    assert ddp["aug_delta"] == pytest.approx(plain["aug_delta"], rel=1e-6)


def test_sharded_draws_are_the_global_batchs():
    """A rank's augmentation and pose rotations (``shard = (rank, 2)``) are
    its rows of the one-process draws for the global batch."""
    cfg = cli_train.config_from_args(cli_train.parse_args(["--preset", "shapenetpart"]))
    x = torch.randn(4, 16, 3, generator=torch.Generator().manual_seed(0))
    rot = torch.eye(3).expand(4, 3, 3).contiguous()
    whole = cli_train.augment_batch(cfg, x, 7)
    pose = cli_train.pose_resample(cfg, x, rot, step=3)
    for rank in range(2):
        rows = slice(2 * rank, 2 * rank + 2)
        got = cli_train.augment_batch(cfg, x[rows], 7, shard=(rank, 2))
        torch.testing.assert_close(got, whole[rows], rtol=0, atol=0)
        p, r = cli_train.pose_resample(cfg, x[rows], rot[rows], step=3, shard=(rank, 2))
        torch.testing.assert_close(p, pose[0][rows], rtol=0, atol=0)
        torch.testing.assert_close(r, pose[1][rows], rtol=0, atol=0)


def test_profiling_and_a_quiet_logger(tmp_path):
    """``count_params`` against ``mpa_tpu``'s on the same classifier,
    ``estimate_flops`` of a Linear, ``profile_trace`` writes a trace, and a
    logger without a directory (a rank other than 0) writes nothing."""
    import jax
    import jax.numpy as jnp

    from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier
    from mpa_tpu.utils.profiling import count_params as jax_count_params
    from mpa_tpu_torch.utils.logging import make_logger
    from mpa_tpu_torch.utils.profiling import count_params, estimate_flops, profile_trace
    from test_torch_port_cls import SMALL

    jm = JaxMarkovClassifier(num_classes=15, **SMALL)
    params = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((2, 128, 3)),
                                            train=False))["params"]
    assert count_params(MarkovClassifier(num_classes=15, **SMALL)) == jax_count_params(params)
    linear = torch.nn.Linear(8, 4)
    assert estimate_flops(linear, torch.zeros(3, 8)) == 2 * 3 * 8 * 4
    with profile_trace(str(tmp_path / "trace")) as prof:
        linear(torch.zeros(3, 8))
    assert prof is not None and list((tmp_path / "trace").iterdir())
    with make_logger(None) as quiet:
        quiet.info("nothing")
        quiet.metrics(1, loss=0.5)
    assert quiet.log_dir is None
