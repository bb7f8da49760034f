"""Port parity, markov_cls inference: each ``mpa_tpu_torch`` module against
its ``mpa_tpu`` twin on the CPU, with the JAX variables carried across by
``from_jax_variables``, eval mode, narrow widths; the whole classifier
against ``mpa_tpu`` and against the frozen torch-oracle fixture; the
converter, the device rule and the package's import hygiene.
"""

import ast
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from oracle_cache import oracle  # noqa: E402

from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.nn import LinearUnit as JaxLinearUnit  # noqa: E402
from mpa_tpu.nn import LocalMerge as JaxLocalMerge  # noqa: E402
from mpa_tpu.nn import LocalTrans as JaxLocalTrans  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier  # noqa: E402
from mpa_tpu_torch.nn import LinearUnit, LocalMerge, LocalTrans  # noqa: E402
from mpa_tpu_torch.serve import load_classifier  # noqa: E402
from mpa_tpu_torch.utils import from_jax_variables, resolve_device  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

# The suite runs several pytest workers side by side. With torch's default of
# one thread per core in each of them, the many small CPU ops of the port's
# training tests spend their time waiting on one another (a 5 s test took
# 400 s). Every CPU test file of the port imports this module.
torch.set_num_threads(1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return out


def jax_variables(module, *args, seed=0, **kw):
    """Init ``module`` and randomise every BN scale/bias/mean/var and Dense
    bias, so the normalisation path is exercised in eval mode."""
    variables = module.init(jax.random.key(seed), *args, train=False, **kw)
    rng = np.random.default_rng(seed)
    flat = _flat(jax.tree_util.tree_map(np.asarray, dict(variables)))
    for key, v in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            flat[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[key] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return flat


def port(module, flat):
    state, unused = from_jax_variables(flat, module)
    module.load_state_dict(state, strict=True)
    return module.eval(), unused


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_linear_unit():
    x = _x(0, (2, 10, 6))
    jm = JaxLinearUnit(12)
    flat = jax_variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(_nest(flat), jnp.asarray(x), train=False))
    tm, unused = port(LinearUnit(6, 12), flat)
    assert unused == []
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("xyz_mode,residual_proj", [(True, True), (False, False), (False, True)])
def test_local_trans(xyz_mode, residual_proj):
    B, N, S, K, C_out = 2, 32, 12, 8, 16
    # Without a residual projection the residual is the centre itself.
    C_in = 3 if xyz_mode else (10 if residual_proj else C_out)
    source = _x(1, (B, N, C_in))
    center = source[:, :S]
    idx = np.random.default_rng(2).integers(0, N, (B, S, K)).astype(np.int32)
    jm = JaxLocalTrans(C_out, K, residual_proj=residual_proj)
    args = (jnp.asarray(source), jnp.asarray(center), jnp.asarray(idx))
    flat = jax_variables(jm, *args, xyz_mode=xyz_mode)
    want = np.asarray(jm.apply(_nest(flat), *args, xyz_mode=xyz_mode, train=False))
    tm, unused = port(LocalTrans(C_in, C_out, K, residual_proj=residual_proj), flat)
    assert unused == []
    with torch.no_grad():
        got = tm(torch.from_numpy(source), torch.from_numpy(center), torch.from_numpy(idx),
                 xyz_mode=xyz_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_local_merge_first_state():
    xyz = _x(3, (2, 48, 3))
    jm = JaxLocalMerge(16, 8, residual=True)
    flat = jax_variables(jm, jnp.asarray(xyz), jnp.asarray(xyz))
    want, widx, wdist = jm.apply(_nest(flat), jnp.asarray(xyz), jnp.asarray(xyz), train=False)
    tm, unused = port(LocalMerge(None, 16, 8, residual=True), flat)
    assert unused == []
    with torch.no_grad():
        got, gidx, gdist = tm(torch.from_numpy(xyz), torch.from_numpy(xyz))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(gdist.numpy(), np.asarray(wdist), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("residual", [False, True])
def test_local_merge_transition(residual):
    B, N, S, C_out = 2, 64, 24, 16
    C_in = 12 if residual else C_out
    base_xyz = _x(4, (B, N, 3))
    feats = _x(5, (B, N, C_in))
    fps_idx = np.stack([np.random.default_rng(6 + b).permutation(N)[:S] for b in range(B)]).astype(np.int32)
    xyz = np.take_along_axis(base_xyz, fps_idx[..., None], 1)
    jm = JaxLocalMerge(C_out, 8, residual=residual)
    jargs = (jnp.asarray(xyz), jnp.asarray(base_xyz))
    jkw = dict(feature=jnp.asarray(feats), fps_idx=jnp.asarray(fps_idx))
    flat = jax_variables(jm, *jargs, **jkw)
    want, _, _ = jm.apply(_nest(flat), *jargs, train=False, **jkw)
    tm, unused = port(LocalMerge(C_in, C_out, 8, residual=residual), flat)
    assert unused == []
    with torch.no_grad():
        got, _, _ = tm(torch.from_numpy(xyz), torch.from_numpy(base_xyz),
                       feature=torch.from_numpy(feats), fps_idx=torch.from_numpy(fps_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


SMALL = dict(npoints=(64, 32, 16, 8, 4), channels=(16, 16, 16, 32, 32, 64), encoder_features=64)


def test_markov_cls_matches_jax():
    x = _x(7, (2, 128, 3))
    jm = JaxMarkovClassifier(num_classes=15, **SMALL)
    flat = jax_variables(jm, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda v, p: jm.apply(v, p, train=False))(_nest(flat), jnp.asarray(x)))
    tm, unused = port(MarkovClassifier(num_classes=15, **SMALL), flat)
    assert unused == []
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 15) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_markov_cls_matches_frozen_torch_oracle():
    """The reference torch model's logits, frozen in tests/fixtures (built by
    tests/torch_side/cls_model.py), at the ladder test_model_parity uses."""
    f = oracle("cls_model_forward", lambda: pytest.fail("fixture cls_model_forward.npz missing"))
    variables = {k: v for k, v in f.items() if k.startswith("variables/")}
    tm = MarkovClassifier(num_classes=15, npoints=(128, 64, 32, 16, 8))
    tm, unused = port(tm, variables)
    # Leaves the reference checkpoint carries that the JAX model never reads.
    assert any("/la0/feature_trans/" in k for k in unused)
    assert any("/la0/fc2/" in k for k in unused)
    assert all("/la0/" in k or "/xyz_trans/" in k for k in unused)
    with torch.inference_mode():
        got = tm(torch.from_numpy(f["x_logits"])).numpy()
        pred = tm(torch.from_numpy(f["x_pred"])).numpy()
    np.testing.assert_allclose(got, f["want_logits"], atol=5e-4)
    np.testing.assert_array_equal(pred.argmax(-1), f["want_pred"].argmax(-1))


def test_from_jax_variables_round_trip():
    x = _x(8, (3, 5, 4))
    jm = JaxLinearUnit(7)
    flat = jax_variables(jm, jnp.asarray(x))
    flat["params/ghost/kernel"] = np.ones((2, 2), np.float32)
    tm = LinearUnit(4, 7)
    state, unused = from_jax_variables(flat, tm)
    assert unused == ["params/ghost/kernel"]
    tm.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(tm.linear.weight.detach().numpy(), flat["params/linear/kernel"].T)
    np.testing.assert_array_equal(tm.norm.weight.detach().numpy(), flat["params/norm/scale"])
    np.testing.assert_array_equal(tm.norm.running_var.numpy(), flat["batch_stats/norm/var"])
    # Nested flax dicts convert to the same state dict as flat keys.
    nested_state, _ = from_jax_variables(_nest(flat), LinearUnit(4, 7))
    assert set(nested_state) == set(state)


def state_to_flax(state):
    """A port ``state_dict`` as flat flax keys, the inverse of the converter."""
    flat = {}
    for name, t in state.items():
        mod, leaf = name.rsplit(".", 1)
        path = "/".join(mod.split("."))
        if leaf == "weight" and t.dim() == 2:
            flat[f"params/{path}/kernel"] = t.t().numpy()
        elif leaf == "weight":
            flat[f"params/{path}/scale"] = t.numpy()
        elif leaf == "bias":
            flat[f"params/{path}/bias"] = t.numpy()
        elif leaf == "running_mean":
            flat[f"batch_stats/{path}/mean"] = t.numpy()
        elif leaf == "running_var":
            flat[f"batch_stats/{path}/var"] = t.numpy()
    return flat


def test_load_classifier_from_variables_on_cpu():
    clf = load_classifier(device="cpu", seed=3)
    flat = state_to_flax(clf.model.state_dict())
    clf2 = load_classifier(variables=flat, device="cpu")
    x = _x(9, (2, 1024, 3))
    a, b = clf(x), clf2(x)
    assert a.shape == (2, 15) and torch.isfinite(a).all()
    torch.testing.assert_close(torch.exp(a).sum(-1), torch.ones(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_seeded_weights_do_not_depend_on_the_call():
    a = load_classifier(device="cpu", seed=0).model.state_dict()
    b = load_classifier(device="cpu", seed=0).model.state_dict()
    c = load_classifier(device="cpu", seed=1).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])


def test_device_rule(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError):
        load_classifier()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    scripts = [REPO / "chip_smoke.py", REPO / "profile_port.py"]
    files = sorted((REPO / "mpa_tpu_torch").rglob("*.py")) + scripts
    assert len(files) > 10 and all(p.exists() for p in scripts)
    walked = {str(p.relative_to(REPO)) for p in files}
    for module in ("train/loop.py", "train/losses.py", "train/schedules.py", "train/metrics.py",
                   "data/synthetic.py", "data/shapenetpart.py", "cli/train.py", "configs.py",
                   "ops/scatter.py", "nn/fuse.py", "nn/keephigh_partseg.py",
                   "models/markov_partseg.py", "serve/__init__.py", "kernels/build.py",
                   "ops/morton.py", "ops/window.py", "nn/window_mode.py",
                   "models/markov_semseg.py", "data/s3dis.py", "geometry/umbrella.py",
                   "ops/ball_query.py", "nn/surface_abstraction.py",
                   "nn/umbrella_constructor.py", "models/repsurf_ssg_2x.py"):
        assert f"mpa_tpu_torch/{module}" in walked
    bad = {
        str(p.relative_to(REPO)): root
        for p in files
        for root in _imported_roots(p)
        if root in ("jax", "flax", "mpa_tpu", "jaxlib", "optax", "orbax")
    }
    assert bad == {}
