"""Port parity, ``--init`` and ``--import_torch``, on the CPU.

- ``utils/init.py``: the ZerO init bit for bit against ``mpa_tpu``'s
  ``apply_weight_init`` (a deterministic init, carried across by
  ``from_jax_variables``); xavier and kaiming by their statistics (mean 0,
  variance ``2 / (fan_in + fan_out)`` and ``2 / fan_in``) and by the leaves
  they touch, the same as ``mpa_tpu``'s; the names it takes.
- ``utils/torch_import.py``: a reference-layout state dict, its keys and
  shapes from the port's key map and the model
  (``chip_smoke.reference_checkpoint``, seeded numpy values, with the dead
  keys a reference checkpoint holds), saved with ``torch.save``, imported
  by the port and by ``mpa_tpu.utils.torch_import`` on the same file: equal
  bit for bit, for cls and part-seg; the ``module.`` prefix; the skipped
  keys reported; ``weights_only`` refusing a pickled object unless
  ``allow_pickle``, which warns.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import SMALL, _nest, jax_variables, port  # noqa: E402

import chip_smoke  # noqa: E402  (reference_checkpoint; imports torch only)
from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu.utils import init as jax_init  # noqa: E402
from mpa_tpu.utils import torch_import as jax_torch_import  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier, MarkovPartSeg  # noqa: E402
from mpa_tpu_torch.nn import LinearUnit  # noqa: E402
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402
from mpa_tpu_torch.utils.init import apply_weight_init, set_seed  # noqa: E402
from mpa_tpu_torch.utils.torch_import import (  # noqa: E402
    import_reference_checkpoint,
    reference_keys,
)

PARTSEG = dict(npoints=(128, 64, 32, 16), channels=(16, 16, 16, 32, 32))


def _flat_tree(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    return out


def _cls_pair():
    x = np.random.default_rng(0).standard_normal((2, 128, 3)).astype(np.float32)
    jm = JaxMarkovClassifier(num_classes=15, **SMALL)
    flat = jax_variables(jm, jnp.asarray(x))
    return _nest(flat), port(MarkovClassifier(num_classes=15, **SMALL), flat)[0]


@pytest.mark.parametrize("name", ["zero", "ZerO"])
def test_zero_init_is_mpa_tpus_bit_for_bit(name):
    nested, model = _cls_pair()
    new = jax_init.apply_weight_init(nested["params"], name, jax.random.key(1))
    want, _ = from_jax_variables({**_flat_tree(new, "params"),
                                  **_flat_tree(nested["batch_stats"], "batch_stats")}, model)
    apply_weight_init(model, name, torch.Generator().manual_seed(1))
    got = model.state_dict()
    for key, w in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], w), key


def test_zero_init_hadamard_branch():
    """``out > in``: the Hadamard branch, scaled by ``2^(-log2(p) / 2)``."""
    from mpa_tpu_torch.utils.init import zero_init_dense

    for out, inn in ((6, 3), (16, 16), (5, 12), (64, 3)):
        want = np.asarray(jax_init.zero_init_dense(None, (inn, out))).T
        got = zero_init_dense(out, inn).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["xavier", "kaiming", "Kaiming"])
def test_xavier_and_kaiming_statistics_and_leaves(name):
    """Large layers for the statistics; the leaves touched are
    ``mpa_tpu``'s: every Dense weight drawn, every bias 0, every norm scale
    1, the running statistics kept."""
    torch.manual_seed(0)
    unit = LinearUnit(384, 512)
    apply_weight_init(unit, name, torch.Generator().manual_seed(2))
    w = unit.linear.weight
    var = 2.0 / (384 + 512) if name == "xavier" else 2.0 / 384
    assert abs(float(w.mean())) < 0.02 * var ** 0.5
    assert abs(float(w.var()) / var - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * (var ** 0.5) / 0.8796256610342398 + 1e-6  # truncated

    nested, model = _cls_pair()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    new = jax_init.apply_weight_init(nested["params"], name, jax.random.key(3))
    jax_after, _ = from_jax_variables({**_flat_tree(new, "params"),
                                       **_flat_tree(nested["batch_stats"], "batch_stats")}, model)
    apply_weight_init(model, name, torch.Generator().manual_seed(3))
    after = model.state_dict()
    for key, b in before.items():
        if key.endswith("num_batches_tracked"):
            continue
        mpa_changed = not torch.equal(jax_after[key], b)
        assert (not torch.equal(after[key], b)) == mpa_changed, key
        if key.endswith("bias") or "running" in key or (key.endswith("weight")
                                                        and after[key].dim() == 1):
            assert torch.equal(after[key], jax_after[key]), key  # 0, 1 or kept


def test_init_names_and_seed():
    with pytest.raises(ValueError, match="no such init type"):
        apply_weight_init(LinearUnit(2, 2), "orthogonal", torch.Generator())
    g = set_seed(5)
    assert isinstance(g, torch.Generator) and torch.equal(
        torch.rand(3, generator=g), torch.rand(3, generator=torch.Generator().manual_seed(5)))


def _template(task):
    if task == "cls":
        x = np.random.default_rng(0).standard_normal((2, 128, 3)).astype(np.float32)
        jm, tm = JaxMarkovClassifier(num_classes=15, **SMALL), MarkovClassifier(
            num_classes=15, **SMALL)
        variables = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    else:
        x = np.random.default_rng(0).standard_normal((2, 256, 3)).astype(np.float32)
        oh = np.eye(16, dtype=np.float32)[[1, 2]]
        jm, tm = JaxMarkovPartSeg(**PARTSEG), MarkovPartSeg(**PARTSEG)
        variables = jm.init(jax.random.key(0), (jnp.asarray(x), jnp.asarray(oh)), train=False)
    return {"params": variables["params"], "batch_stats": variables["batch_stats"]}, tm


@pytest.mark.parametrize("prefix", ["", "module."])
@pytest.mark.parametrize("task", ["cls", "partseg"])
def test_import_equals_mpa_tpus_bit_for_bit(task, prefix, tmp_path):
    template, model = _template(task)
    sd = chip_smoke.reference_checkpoint(task, model, seed=4)
    path = tmp_path / "best_model.pth"
    torch.save({"epoch": 7, "model_state_dict": {prefix + k: v for k, v in sd.items()}}, path)
    variables, jreport = jax_torch_import.import_reference_checkpoint(str(path), task, template)
    want, unused = from_jax_variables(variables, model)
    assert unused == []
    report = import_reference_checkpoint(str(path), task, model)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    # Every reference key the model does not read is reported, as mpa_tpu reports it.
    assert report["skipped_torch_keys"] == jreport["skipped_torch_keys"]
    skipped = report["skipped_torch_keys"]
    assert any("normal_Trans" in k for k in skipped)
    assert any(k.endswith("norm1.weight") for k in skipped)
    assert any(k.endswith("num_batches_tracked") for k in skipped)
    assert not [k for k in skipped if not any(t in k for t in (
        "normal_Trans", "norm1", "num_batches_tracked"))]
    mapped = set(reference_keys(task, model).values())
    assert mapped.isdisjoint(skipped) and len(mapped) + len(skipped) == len(sd)


class _Payload:
    """A pickled object that the weights-only loader must refuse."""

    def __reduce__(self):
        return (dict, ())


def test_weights_only_refuses_a_pickled_object(tmp_path):
    _, model = _template("cls")
    sd = chip_smoke.reference_checkpoint("cls", model, seed=5)
    path = tmp_path / "best_model.pth"
    torch.save({"model_state_dict": sd, "extra": _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError):
        import_reference_checkpoint(str(path), "cls", model)
    with pytest.warns(UserWarning, match="arbitrary code"):
        report = import_reference_checkpoint(str(path), "cls", model, allow_pickle=True)
    assert "normal_Trans" in " ".join(report["skipped_torch_keys"])
    missing = dict(sd)
    missing.pop("fc3.weight")
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(KeyError, match="fc3.weight"):
        import_reference_checkpoint(str(tmp_path / "missing.pth"), "cls", model)
    with pytest.raises(ValueError, match="task"):
        reference_keys("semseg", model)
