"""Port parity, ``repsurf_ssg_2x`` eval-mode gradients and the umbrella
constructor inside ``markov_cls``, on the CPU.

As in ``tests/test_torch_port_repsurf.py``, ``mpa_tpu`` runs on the CPU and
the port takes its plain ops. Covered: the classifier's eval-mode gradients
against ``jax.grad``; ``MarkovClassifier(use_umbrella=True)`` with its
variables carried over, in eval mode and in a train-mode forward that
updates the constructor's BatchNorm statistics.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import _nest, jax_variables, port  # noqa: E402
from test_torch_port_repsurf import SMALL, _t, _x  # noqa: E402
from test_torch_port_repsurf_train import _flips  # noqa: E402
from test_torch_port_train import _params_of  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.models.repsurf_ssg_2x import RepSurfSSG2x as JaxRepSurf  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier, RepSurfSSG2x  # noqa: E402
from mpa_tpu_torch.train import cls_loss  # noqa: E402
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402


def test_repsurf_eval_grads_match_jax():
    """Eval-mode gradients of the mean NLL with respect to every parameter
    and the input cloud, against ``jax.grad``: atol 1e-5 plus 1e-3 of each
    tensor's largest entry (float32 sums in another order through the max
    pools, whose ties split the gradient evenly on both sides)."""
    B = 4
    x = _x(20, (B, 128, 3), scale=0.2)
    y = np.random.default_rng(21).integers(0, 15, B)
    jm = JaxRepSurf(num_classes=15, **SMALL)
    flat = jax_variables(jm, jnp.asarray(x))
    nested = _nest(flat)

    def jloss(params, pts):
        out = jm.apply({"params": params, "batch_stats": nested["batch_stats"]}, pts, train=False)
        return jtr.cls_loss(out, jnp.asarray(y))

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(nested["params"], jnp.asarray(x))
    model, _ = port(RepSurfSSG2x(num_classes=15, **SMALL), flat)
    xt = _t(x).requires_grad_(True)
    cls_loss(model(xt), torch.from_numpy(y)).backward()
    flat_want = {"params/" + "/".join(p.key for p in path): np.asarray(leaf)
                 for path, leaf in jax.tree_util.tree_flatten_with_path(want_p)[0]}
    want, unused = from_jax_variables(flat_want, model)
    params = _params_of(model)
    assert unused == [] and set(want) == set(params) and len(params) > 60
    for name, p in params.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 + 1e-3 * np.abs(w).max(),
                                   err_msg=f"grad mismatch at {name}")
    w = np.asarray(want_x)
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), w, rtol=0, atol=1e-5 + 1e-3 * np.abs(w).max())


# -- markov_cls with the umbrella constructor --------------------------------------------

CLS_SMALL = dict(npoints=(64, 32, 16, 8, 4), channels=(16, 16, 16, 32, 32, 64), encoder_features=64)


def test_markov_cls_with_umbrella_matches_mpa_tpu():
    """``use_umbrella=True``: the constructor's variables carry over; in eval
    mode the log-probs are those without it (its output is unused); a
    train-mode forward with the key's flips updates its BatchNorm statistics
    as ``mpa_tpu``'s does, and gives the same log-probs."""
    B = 4
    x = _x(41, (B, 128, 3), scale=0.5)
    jm = JaxMarkovClassifier(num_classes=15, dropout=0.0, use_umbrella=True, **CLS_SMALL)
    flat = jax_variables(jm, jnp.asarray(x))
    assert any("/surface_constructor/" in k for k in flat)
    jfwd = jax.jit(lambda v, p: jm.apply(v, p, train=False))
    want = np.asarray(jfwd(_nest(flat), jnp.asarray(x)))
    tm, unused = port(MarkovClassifier(num_classes=15, dropout=0.0, use_umbrella=True, **CLS_SMALL),
                      flat)
    assert unused == []
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    key = jax.random.key(9)
    jtrain = jax.jit(lambda v, p: jm.apply(v, p, train=True, rng=key, mutable=["batch_stats"]))
    want_t, upd = jtrain(_nest(flat), jnp.asarray(x))
    tm.train()
    got_t = tm(_t(x), flips=torch.from_numpy(_flips(key, B)))
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t), rtol=0, atol=1e-4)
    for bn in ("bn0", "bn1"):
        stats = upd["batch_stats"]["surface_constructor"][bn]
        module = getattr(tm.surface_constructor, bn)
        np.testing.assert_allclose(module.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(module.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-5, atol=1e-6)
    assert not torch.equal(tm.surface_constructor.bn0.running_var, torch.ones(10))
