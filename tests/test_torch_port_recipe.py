"""Port parity, the published recipe: ``data/augment.py``'s cores against
``mpa_tpu.data.augment`` on the values JAX drew (the test draws them again
with the same key and the same ``jax.random`` call), the port's own draws,
``train/votes.py`` against ``mpa_tpu.train.votes`` (a stand-in forward, and
``markov_cls`` at a small width against ``mpa_tpu``'s eval step), the
part-seg point accuracies against ``mpa_tpu``'s, and the train
augmentation of ``cli.train``, whose draws depend on the seed and the step
alone, a resumed run's too.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import SMALL, _nest, _x, jax_variables, port  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.data import augment as jaug  # noqa: E402
from mpa_tpu.data.shapenetpart import SEG_PARTS as JAX_SEG_PARTS  # noqa: E402
from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.train import metrics as jax_metrics  # noqa: E402
from mpa_tpu.train import votes as jvotes  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS  # noqa: E402
from mpa_tpu_torch.data import SEG_PARTS  # noqa: E402
from mpa_tpu_torch.data import augment  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier  # noqa: E402
from mpa_tpu_torch.train import (  # noqa: E402
    class_avg_point_accuracy,
    draw_vote_scales,
    point_accuracy,
    scale_point_cloud,
    vote_predict,
)

B, N = 5, 64
augment_batch = cli_train.augment_batch  # as defined, before a test replaces it


def _pts(seed, C=3):
    return _x(seed, (B, N, C))


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the cores against mpa_tpu, on JAX's draws --------------------------------------------


@pytest.mark.parametrize("C", [3, 6])
def test_scale_and_shift_cores_are_bit_equal(C):
    pts, key = _pts(1, C), jax.random.key(3)
    s = jax.random.uniform(key, (B, 1, 1), minval=0.8, maxval=1.25)
    want = np.asarray(jaug.random_scale(key, jnp.asarray(pts)))
    np.testing.assert_array_equal(augment.scale_points(_t(pts), _t(s)).numpy(), want)
    t = jax.random.uniform(key, (B, 1, C), minval=-0.1, maxval=0.1)
    want = np.asarray(jaug.random_shift(key, jnp.asarray(pts)))
    got = augment.shift_points(_t(pts), _t(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.allclose(got[..., 3:], pts[..., 3:]) or C == 3  # every channel shifts


def test_jitter_core_is_bit_equal():
    pts, key = _pts(2), jax.random.key(4)
    normal = jax.random.normal(key, pts.shape)
    want = np.asarray(jaug.random_jitter(key, jnp.asarray(pts)))
    np.testing.assert_array_equal(augment.jitter_points(_t(pts), _t(normal)).numpy(), want)


def test_transform_point_cloud_core_is_bit_equal():
    pts, key = _pts(3), jax.random.key(5)
    k1, k2 = jax.random.split(key)
    s = jax.random.uniform(k1, (B, 1, 1), minval=0.5, maxval=1.5)
    t = jax.random.uniform(k2, (B, 1, 3), minval=-0.3, maxval=0.3)
    want = np.asarray(jaug.transform_point_cloud(key, jnp.asarray(pts), aug_scale=True,
                                                 aug_shift=True))
    got = augment.shift_points(augment.scale_points(_t(pts), _t(s)), _t(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert augment.get_aug_args("ScanObjectNN") == jaug.get_aug_args("ScanObjectNN")
    assert augment.get_aug_args("modelnet40") == jaug.get_aug_args("modelnet40")


def _angles(key):
    return jax.random.uniform(key, (B,), maxval=2.0 * jnp.pi)


def _perturb(key):
    return jnp.clip(0.06 * jax.random.normal(key, (B, 3)), -0.18, 0.18)


@pytest.mark.parametrize("name,C,core,draw", [
    ("random_rotate_y", 3, augment.rotate_by_angle, _angles),
    ("random_rotate_z", 3, augment.rotate_z_by_angle, _angles),
    ("random_rotate_perturb", 3, augment.rotate_perturb_by_angles, _perturb),
    ("random_rotate_y_with_normal", 6, augment.rotate_by_angle, _angles),
    ("random_rotate_perturb_with_normal", 6, augment.rotate_perturb_by_angles, _perturb),
    ("random_rotate_perturb_with_normal", 7, augment.rotate_perturb_by_angles, _perturb),
])
def test_rotation_cores_match(name, C, core, draw):
    pts, key = _pts(4, C), jax.random.key(6)
    want = np.asarray(getattr(jaug, name)(key, jnp.asarray(pts)))
    got = core(_t(pts), _t(draw(key))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("C,angle", [(3, 0.7), (6, 1.3), (7, None)])
def test_rotate_by_angle_matches(C, angle):
    pts = _pts(5, C)
    angle = np.linspace(0.0, 6.0, B).astype(np.float32) if angle is None else angle
    want = np.asarray(jaug.rotate_by_angle(jnp.asarray(pts), angle))
    got = augment.rotate_by_angle(_t(pts), angle).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dropout_and_shuffle_cores_are_exact():
    pts, key = _pts(6), jax.random.key(7)
    k_ratio, k_mask = jax.random.split(key)
    ratio = jax.random.uniform(k_ratio, (B, 1))
    drop = jax.random.uniform(k_mask, (B, N)) <= ratio * 0.875
    want = np.asarray(jaug.random_point_dropout(key, jnp.asarray(pts)))
    np.testing.assert_array_equal(augment.dropout_points(_t(pts), _t(drop)).numpy(), want)
    keys = jax.random.split(key, B)
    perm = jax.vmap(lambda k: jax.random.permutation(k, N))(keys)
    want = np.asarray(jaug.shuffle_points(key, jnp.asarray(pts)))
    got = augment.permute_points(_t(pts), _t(np.asarray(perm, np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_normalize_point_cloud_matches():
    pts = 3.0 * _pts(7) + 1.0
    want = np.asarray(jaug.normalize_point_cloud(jnp.asarray(pts)))
    np.testing.assert_allclose(augment.normalize_point_cloud(_t(pts)).numpy(), want,
                               rtol=0, atol=1e-6)


# -- the port's draws ----------------------------------------------------------------------


def _g(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("fn,kw", [
    ("random_scale", {}), ("random_shift", {}), ("random_jitter", {}),
    ("random_rotate_y", {}), ("random_rotate_z", {}), ("random_rotate_perturb", {}),
    ("random_point_dropout", {}), ("shuffle_points", {}),
    ("transform_point_cloud", dict(aug_scale=True, aug_shift=True)),
])
def test_draws_follow_the_generator(fn, kw):
    x = torch.from_numpy(_x(8, (64, 128, 3)))
    a = getattr(augment, fn)(x, _g(1), **kw)
    b = getattr(augment, fn)(x, _g(1), **kw)
    c = getattr(augment, fn)(x, _g(2), **kw)
    assert a.shape == x.shape and a.device == x.device and a.dtype == x.dtype
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, x)


def test_draw_ranges_and_per_cloud_independence():
    x = torch.from_numpy(_x(9, (256, 32, 6)))
    s = augment.random_scale(x, _g(0)) / x
    s = s[:, 0, 0]
    assert float(s.min()) >= 0.8 and float(s.max()) < 1.25 and s.unique().numel() == 256
    t = (augment.random_shift(x, _g(0)) - x)[:, 0, :]
    assert float(t.abs().max()) <= 0.1 and t.flatten().unique().numel() == 256 * 6
    a = augment.draw_angles(_g(0), x)
    assert a.shape == (256,) and float(a.min()) >= 0 and float(a.max()) < 2 * np.pi
    p = augment.draw_perturb_angles(_g(0), x)
    assert p.shape == (256, 3) and float(p.abs().max()) <= np.float32(0.18)
    r = augment.random_rotate_perturb(x, _g(0))
    torch.testing.assert_close(r[..., :3].norm(dim=-1), x[..., :3].norm(dim=-1))
    torch.testing.assert_close(r[..., 3:].norm(dim=-1), x[..., 3:].norm(dim=-1))
    drop = augment.draw_dropout_mask(_g(0), x)
    rates = drop.float().mean(-1)
    assert drop.shape == (256, 32) and float(rates.max()) <= 1.0 and rates.unique().numel() > 20
    perm = augment.draw_permutations(_g(0), x)
    assert torch.equal(perm.sort(-1).values, torch.arange(32).expand(256, 32))
    assert len({tuple(row.tolist()) for row in perm}) == 256
    scales = draw_vote_scales(_g(0), x)
    assert scales.shape == (256, 1, 3) and scales.device == x.device
    assert float(scales.min()) >= 0.95 and float(scales.max()) < 1.05


# -- votes ---------------------------------------------------------------------------------


def _vote_scales(key, votes, lo=0.95, hi=1.05):
    return [jax.random.uniform(jax.random.fold_in(key, v), (B, 1, 3), minval=lo, maxval=hi)
            for v in range(1, votes)]


@pytest.mark.parametrize("C", [3, 6])
def test_scale_point_cloud_matches(C):
    pts, key = _pts(10, C), jax.random.key(8)
    (s,) = _vote_scales(key, 2)
    want = np.asarray(jvotes.scale_point_cloud(jax.random.fold_in(key, 1), jnp.asarray(pts)))
    got = scale_point_cloud(_t(pts), _t(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("votes", [1, 3, 10])
def test_vote_predict_matches_with_a_stand_in_forward(votes):
    pts, key = _pts(11), jax.random.key(9)
    w = _x(12, (3, 7))

    def jforward(x):
        return jax.nn.log_softmax(jnp.tanh(x).mean(1) @ jnp.asarray(w), axis=-1)

    def forward(x):
        return torch.log_softmax(torch.tanh(x).mean(1) @ torch.from_numpy(w), dim=-1)

    want_pool, want_single = jvotes.vote_predict(jforward, jnp.asarray(pts), key, votes)
    pool, single = vote_predict(forward, _t(pts), votes,
                                scales=[_t(s) for s in _vote_scales(key, votes)])
    np.testing.assert_allclose(pool.numpy(), np.asarray(want_pool), rtol=0, atol=1e-6)
    np.testing.assert_allclose(single.numpy(), np.asarray(want_single), rtol=0, atol=1e-6)
    # From a generator: vote 0 is the clean pass, the same seed the same pool.
    a, s0 = vote_predict(forward, _t(pts), votes, generator=_g(1))
    b, _ = vote_predict(forward, _t(pts), votes, generator=_g(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(s0, forward(_t(pts)), rtol=0, atol=0)


def test_vote_predict_needs_its_scales():
    with pytest.raises(ValueError, match="generator"):
        vote_predict(lambda x: x, torch.zeros(2, 4, 3), 3)
    with pytest.raises(ValueError, match="2 vote scales"):
        vote_predict(lambda x: x, torch.zeros(2, 4, 3), 2, scales=[torch.ones(2, 1, 3)] * 2)


def test_vote_predict_through_markov_cls_matches_mpa_tpu():
    pts, key = _x(13, (2, 128, 3)), jax.random.key(10)
    jm = JaxMarkovClassifier(num_classes=15, **SMALL)
    flat = jax_variables(jm, jnp.asarray(pts))
    nested = _nest(flat)
    jstate = jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"],
                                   tx=jtr.make_optimizer("sgd", 0.0),
                                   batch_stats=nested["batch_stats"])
    eval_step = jax.jit(jtr.make_eval_step())
    want_pool, want_single = jvotes.vote_predict(lambda x: eval_step(jstate, x),
                                                 jnp.asarray(pts), key, 3)
    tm, _ = port(MarkovClassifier(num_classes=15, **SMALL), flat)
    scales = [jax.random.uniform(jax.random.fold_in(key, v), (2, 1, 3), minval=0.95, maxval=1.05)
              for v in (1, 2)]
    with torch.inference_mode():
        pool, single = vote_predict(tm, _t(pts), 3, scales=[_t(s) for s in scales])
    np.testing.assert_allclose(single.numpy(), np.asarray(want_single), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pool.numpy(), np.asarray(want_pool), rtol=1e-5, atol=1e-5)


# -- the part-seg point accuracies ------------------------------------------------------------


def test_point_accuracies_match_mpa_tpu():
    assert SEG_PARTS == JAX_SEG_PARTS
    rng = np.random.default_rng(14)
    preds, targets = [], []
    for i in range(12):
        parts = SEG_PARTS[i % 5]
        targets.append(rng.choice(parts, size=200))
        preds.append(np.where(rng.random(200) < 0.7, targets[-1], rng.choice(parts, size=200)))
    assert point_accuracy(preds, targets) == jax_metrics.point_accuracy(preds, targets)
    got = class_avg_point_accuracy(preds, targets, SEG_PARTS)
    assert got == jax_metrics.class_avg_point_accuracy(preds, targets, JAX_SEG_PARTS)
    assert 0.5 < got < 0.95
    assert point_accuracy([], []) == 0.0 == class_avg_point_accuracy([], [], SEG_PARTS)


# -- the train augmentation of cli.train ---------------------------------------------------------


def test_augment_batch_depends_on_the_seed_and_step_alone():
    cfg = PRESETS["shapenetpart"]
    x = torch.from_numpy(_x(15, (4, 256, 3)))
    a = cli_train.augment_batch(cfg, x, 7)
    torch.testing.assert_close(a, cli_train.augment_batch(cfg, x, 7), rtol=0, atol=0)
    assert not torch.equal(a, cli_train.augment_batch(cfg, x, 8))
    assert not torch.equal(a, cli_train.augment_batch(cfg.with_overrides(seed=1), x, 7))
    # Scale in [0.8, 1.25), then shift in [-0.1, 0.1), per cloud and channel.
    ones = cli_train.augment_batch(cfg, torch.ones(4, 1, 3), 7)
    zeros = cli_train.augment_batch(cfg, torch.zeros(4, 1, 3), 7)
    s, t = ones - zeros, zeros
    assert float(s.min()) >= 0.8 and float(s.max()) < 1.25 and float(t.abs().max()) <= 0.1
    torch.testing.assert_close(a, x * s + t)
    cls = PRESETS["scanobjectnn_cls"]
    assert cli_train.augment_batch(cls, x, 7) is x  # cls: only with the flags
    scaled = cli_train.augment_batch(cls.with_overrides(aug_scale=True), x, 7)
    assert not torch.equal(scaled, x)
    torch.testing.assert_close(scaled / x, (scaled / x)[:, :1, :1].expand_as(x))


def _recorded_draws(monkeypatch, argv):
    """Run ``cli.train`` and return, per state step, the draws its train
    augmentation made there (as the augmentation of zeros and of ones)."""
    seen = {}

    def recording(cfg, points, step, shard=(0, 1)):
        probe = torch.stack([torch.zeros_like(points), torch.ones_like(points)])
        seen[step] = augment_batch(cfg, probe.flatten(0, 1), step).reshape(probe.shape)
        return augment_batch(cfg, points, step, shard)

    monkeypatch.setattr(cli_train, "augment_batch", recording)
    out = cli_train.main(argv)
    return seen, out


def test_partseg_draws_of_a_resumed_run_are_an_unbroken_runs(monkeypatch, tmp_path, capsys):
    argv = ["--preset", "shapenetpart", "--device", "cpu", "--num_points", "256",
            "--batch_size", "2", "--train_clouds", "8", "--eval_clouds", "2", "--seed", "0"]
    unbroken, out = _recorded_draws(
        monkeypatch, argv + ["--max_steps", "4", "--log_dir", str(tmp_path / "a")])
    assert sorted(unbroken) == [0, 1, 2, 3] and out["steps"] == 4
    assert out["aug_delta"] > 0
    first, _ = _recorded_draws(
        monkeypatch, argv + ["--max_steps", "2", "--log_dir", str(tmp_path / "b")])
    resumed, out = _recorded_draws(
        monkeypatch, argv + ["--max_steps", "2", "--log_dir", str(tmp_path / "b")])
    assert sorted(first) == [0, 1] and sorted(resumed) == [2, 3] and out["steps"] == 2
    assert "resumed from" in capsys.readouterr().out
    for step, draws in {**first, **resumed}.items():
        torch.testing.assert_close(draws, unbroken[step], rtol=0, atol=0)
    assert not torch.equal(unbroken[0], unbroken[1])
