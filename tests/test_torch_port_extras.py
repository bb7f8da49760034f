"""Port parity, the extras (``mpa_tpu_torch/extras``), on the CPU.

``mpa_tpu`` runs as ``tests/test_extras.py`` runs it: JAX on the CPU, its
flax modules initialised and applied under ``jax.jit`` (its kNN takes the
sort there and its gather the XLA formulation). The port takes its plain
ops, the tensors lying on the CPU; ``knn_kernel``, ``gather_rows_kernel``
and ``scatter_add_rows_kernel`` are held against those plain ops on the
card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase 10).

Covered: ``dgcnn`` in both registries with ``mpa_tpu``'s defaults;
``get_graph_feature``; DGCNN at narrow widths (k = 4, widths 8/8/16/16,
B = 2, N = 32) with ``mpa_tpu``'s variables carried across, in eval mode
and in train mode with ``dropout=0`` (the cls loss, its gradients and the
updated BatchNorm statistics against eager ``mpa_tpu`` in float64); the
NetVLAD modules and the four displacement modules in eval and train mode;
the raw parameters carried across strictly and drawn by ``init_like_flax``;
two steps of ``cli.train --model dgcnn`` on synthetic clouds and
``cli.eval`` of its checkpoint.

Feature-space kNN near-ties: ``mpa_tpu`` sums its float32 distances in
XLA's blocked einsum order, the port in channel order, so a k-th and
(k+1)-th neighbour within a few roundings of each other may be picked in
either order. ``assert_knn_apart`` checks, before any comparison, that
every query's k-th and (k+1)-th distance as ``mpa_tpu`` computes them at
each block's input lie at least ``4 (C + 2)`` roundings apart (a rounding:
float32's eps times ``|q|^2 + max |b|^2``, the terms of the distance): a
seed that sits on a near tie fails there, loudly. Seed 0's train-mode run
is such a seed (its third kNN input's margin is 23.9 roundings against 40).

Tolerances: the DGCNN's logits in float32 within 1e-5 (relative and
absolute: float32 products in another order through six Dense layers); in
float64 the loss within 1e-12, each gradient within 1e-9 of its largest
entry plus 1e-12 of the whole gradient's norm (``linear2.bias`` and the
EdgeConv BatchNorms' inputs have gradients that are zero up to rounding),
the running statistics within 1e-12; ``get_graph_feature`` bit for bit
(the same subtraction of the same gathered rows); the modules within 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)
from test_torch_port_cls import _flat, _nest, port  # noqa: E402

from mpa_tpu import train as jtr  # noqa: E402
from mpa_tpu.extras import DGCNN as JaxDGCNN  # noqa: E402
from mpa_tpu.extras import Disp3DEncoder as JaxDisp3DEncoder  # noqa: E402
from mpa_tpu.extras import GatingContext as JaxGatingContext  # noqa: E402
from mpa_tpu.extras import NeighborPooling as JaxNeighborPooling  # noqa: E402
from mpa_tpu.extras import NetVLAD as JaxNetVLAD  # noqa: E402
from mpa_tpu.extras import Operator3D as JaxOperator3D  # noqa: E402
from mpa_tpu.extras import OperatorND as JaxOperatorND  # noqa: E402
from mpa_tpu.extras import SpatialPyramidNetVLAD as JaxSpatialPyramidNetVLAD  # noqa: E402
from mpa_tpu.extras import get_graph_feature as jax_get_graph_feature  # noqa: E402
from mpa_tpu.models import list_models as jax_list_models  # noqa: E402
from mpa_tpu.ops import square_distance as jax_square_distance  # noqa: E402
from mpa_tpu_torch.cli import eval as cli_eval  # noqa: E402
from mpa_tpu_torch.cli import train as cli_train  # noqa: E402
from mpa_tpu_torch.configs import PRESETS, model_kwargs  # noqa: E402
from mpa_tpu_torch.extras import (  # noqa: E402
    DGCNN, Disp3DEncoder, GatingContext, NeighborPooling, NetVLAD, Operator3D, OperatorND,
    SpatialPyramidNetVLAD, get_graph_feature,
)
from mpa_tpu_torch.models import get_model, list_models  # noqa: E402
from mpa_tpu_torch.train import smooth_cls_loss  # noqa: E402
from mpa_tpu_torch.utils.convert import from_jax_variables  # noqa: E402
from mpa_tpu_torch.utils.init import init_like_flax  # noqa: E402

EPS = float(np.finfo(np.float32).eps)
NARROW = dict(num_classes=5, k=4, block_widths=(8, 8, 16, 16))
SEED = 1  # seed 0's train-mode run sits on a near tie (module doc)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flax_variables(module, *args, seed=0, trains=True):
    """``module``'s variables from a jitted init (in eval mode where it
    ``trains``, has a train mode), every BatchNorm scale, bias and statistic
    and every Dense bias randomised (the idiom of
    ``test_torch_port_cls.jax_variables``, whose eager init takes 10 s for
    DGCNN)."""
    kw = {"train": False} if trains else {}
    variables = jax.jit(lambda r, *a: module.init(r, *a, **kw))(jax.random.key(seed), *args)
    flat = _flat(jax.tree_util.tree_map(np.asarray, dict(variables)))
    rng = np.random.default_rng(seed)
    for key, v in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            flat[key] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            flat[key] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return flat


def assert_knn_apart(inputs, k):
    """Setup: at each kNN input ``[B, N, C]`` (``mpa_tpu``'s own values),
    every query's k-th and (k+1)-th smallest distance as ``mpa_tpu``
    computes it lie at least ``4 (C + 2)`` roundings apart (module doc)."""
    for i, z in enumerate(inputs):
        d = np.sort(np.asarray(jax_square_distance(z, z), np.float64), -1)
        n2 = np.sum(np.asarray(z, np.float64) ** 2, -1)
        unit = EPS * (n2 + n2.max(-1, keepdims=True))
        margin = float(((d[..., k] - d[..., k - 1]) / unit).min())
        need = 4 * (z.shape[-1] + 2)
        if margin < need:
            raise AssertionError(f"kNN input {i}: a k-th and (k+1)-th neighbour {margin:.1f} "
                                 f"roundings apart (need {need}): a near tie, take another seed")


def _block_inputs(x, intermediates):
    """DGCNN's four kNN inputs: the points and the first three blocks'
    outputs."""
    return [x] + [intermediates[f"edge{i}"]["__call__"][0] for i in (1, 2, 3)]


# -- DGCNN -----------------------------------------------------------------------------


def test_dgcnn_is_registered_with_mpa_tpus_defaults():
    assert "dgcnn" in list_models() and "dgcnn" in jax_list_models()
    model = get_model("dgcnn")
    jm = JaxDGCNN()
    assert (model.linear3.out_features, model.edge1.k, model.dropout) == (
        jm.num_classes, jm.k, jm.dropout) == (13, 20, 0.5)
    assert [getattr(model, f"edge{i}").conv.out_features for i in (1, 2, 3, 4)] == list(
        jm.block_widths)
    # The bias layout: conv, conv5 and linear1 bias-free, linear2 and linear3 with one.
    assert model.edge1.conv.bias is None and model.conv5.bias is None
    assert model.linear1.bias is None
    assert model.linear2.bias is not None and model.linear3.bias is not None
    cfg = PRESETS["scanobjectnn_cls"].with_overrides(model="dgcnn")
    assert model_kwargs(cfg) == {"num_classes": 15}


def test_get_graph_feature_matches_mpa_tpu():
    x = _x(3, (2, 32, 8))
    assert_knn_apart([jnp.asarray(x)], 4)
    want = np.asarray(jax.jit(lambda a: jax_get_graph_feature(a, 4))(jnp.asarray(x)))
    got = get_graph_feature(_t(x), 4).numpy()
    assert got.shape == (2, 32, 4, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :, 0, :8], 0.0)  # each point is its own first neighbour


@pytest.fixture(scope="module")
def dgcnn_eval():
    x = _x(SEED, (2, 32, 3))
    jm = JaxDGCNN(**NARROW)
    flat = flax_variables(jm, jnp.asarray(x), seed=SEED)
    want, upd = jax.jit(lambda v, a: jm.apply(v, a, train=False, capture_intermediates=True,
                                              mutable=["intermediates"]))(_nest(flat),
                                                                          jnp.asarray(x))
    assert_knn_apart(_block_inputs(jnp.asarray(x), upd["intermediates"]), NARROW["k"])
    return x, flat, np.asarray(want)


def test_dgcnn_eval_matches_mpa_tpu(dgcnn_eval):
    x, flat, want = dgcnn_eval
    tm, unused = port(DGCNN(**NARROW), flat)
    assert unused == []
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def dgcnn_train64():
    """Eager ``mpa_tpu`` in float64 (``jax_enable_x64``), train mode,
    dropout 0: the logits, the label-smoothed cls loss (read on logits, as
    ``mpa_tpu`` trains ``dgcnn``), its gradients and the updated BatchNorm
    statistics, from the float32 variables it starts from."""
    x = _x(SEED, (2, 32, 3))
    y = np.array([1, 3])
    jm = JaxDGCNN(dropout=0.0, **NARROW)
    flat = flax_variables(jm, jnp.asarray(x), seed=SEED)
    with jax.enable_x64(True):
        nested = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _nest(flat))
        x64 = jnp.asarray(x, jnp.float64)

        def loss_fn(params):
            out, upd = jm.apply({"params": params, "batch_stats": nested["batch_stats"]}, x64,
                                train=True, rngs={"dropout": jax.random.key(0)},
                                capture_intermediates=True,
                                mutable=["batch_stats", "intermediates"])
            return jtr.smooth_cls_loss(out, jnp.asarray(y), 0.1), upd

        (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(nested["params"])
        assert_knn_apart(_block_inputs(x64, upd["intermediates"]), NARROW["k"])
        grads = {"params/" + "/".join(p.key for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
        stats = {"batch_stats/" + "/".join(p.key for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]}
    return dict(x=x, y=y, flat=flat, loss=float(loss), grads=grads, stats=stats)


def test_dgcnn_train_mode_matches_eager_mpa_tpu_in_float64(dgcnn_train64):
    ref = dgcnn_train64
    tm, _ = port(DGCNN(dropout=0.0, **NARROW), ref["flat"])
    tm = tm.double().train()
    loss = smooth_cls_loss(tm(_t(ref["x"]).double()), torch.from_numpy(ref["y"]), 0.1)
    loss.backward()
    assert abs(loss.item() - ref["loss"]) <= 1e-12
    want, _ = from_jax_variables(ref["grads"], tm)
    grads = dict(tm.named_parameters())
    assert set(want) == set(grads)
    total = float(np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values())))
    for name, w in want.items():
        g = grads[name].grad
        tol = 1e-9 * float(w.abs().max()) + 1e-12 * total
        assert float((g - w).abs().max()) <= tol, name
    stats, _ = from_jax_variables(ref["stats"], tm)
    buffers = dict(tm.named_buffers())
    assert {n for n in stats if "running" in n} == {n for n in buffers if "running" in n}
    for name, w in stats.items():
        if "running" in name:
            np.testing.assert_allclose(buffers[name].numpy(), w.numpy(), rtol=0, atol=1e-12)


def test_cli_train_and_eval_dgcnn_on_the_cpu(tmp_path):
    """``cli.train --preset scanobjectnn_cls --model dgcnn`` two steps on
    synthetic clouds (64 points, k = 20 still below them), then ``cli.eval``
    of its checkpoint. (``cli.export`` of a DGCNN checkpoint runs on the
    card, ``chip_smoke.py`` phase 10c: on the CPU its trace of the plain kNN
    takes half a minute.)"""
    common = ["--preset", "scanobjectnn_cls", "--model", "dgcnn", "--dataset", "synthetic",
              "--device", "cpu", "--num_points", "64", "--log_dir", str(tmp_path)]
    out = cli_train.main(common + ["--batch_size", "4", "--train_clouds", "8",
                                   "--eval_clouds", "4", "--max_steps", "2"])
    assert out["steps"] == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["instance_acc"] <= 1.0
    ckpt = tmp_path / "scanobjectnn_cls_synthetic" / "checkpoints"
    res = cli_eval.main(common + ["--checkpoint", str(ckpt), "--num_votes", "2",
                                  "--batch_size", "32"])
    assert res["clouds"] == 128 and 0.0 <= res["vote_acc"] <= 1.0


# -- NetVLAD ---------------------------------------------------------------------------


def _check_module(jm, tm_fn, *arrays, atol=1e-5, trains=True):
    """``jm`` and its port from the same variables, in eval mode and, where
    it ``trains`` (has a train mode), in train mode (batch statistics, and
    the updated running ones), within ``atol``; returns the port."""
    jargs = [jnp.asarray(a) for a in arrays]
    flat = flax_variables(jm, *jargs, trains=trains)
    tm, unused = port(tm_fn(), flat)
    assert unused == []
    kw = {"train": False} if trains else {}
    want = jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(_nest(flat), *jargs)
    with torch.inference_mode():
        got = tm(*[_t(a) for a in arrays])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)
    if not trains:
        return tm
    want, upd = jax.jit(lambda v, *a: jm.apply(v, *a, train=True, mutable=["batch_stats"]))(
        _nest(flat), *jargs)
    tm.train()
    with torch.no_grad():
        got = tm(*[_t(a) for a in arrays])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)
    stats, _ = from_jax_variables(_flat(jax.tree_util.tree_map(np.asarray, dict(upd))), tm)
    for name, v in stats.items():
        if "running" in name:
            np.testing.assert_allclose(tm.state_dict()[name].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6)
    return tm


@pytest.mark.parametrize("bn", [True, False])
def test_gating_context_matches_mpa_tpu(bn):
    _check_module(JaxGatingContext(add_batch_norm=bn), lambda: GatingContext(12, bn),
                  _x(4, (6, 12)))


@pytest.mark.parametrize("bn", [True, False])
def test_netvlad_matches_mpa_tpu(bn):
    _check_module(JaxNetVLAD(cluster_size=8, add_batch_norm=bn), lambda: NetVLAD(16, 8, bn),
                  _x(5, (2, 64, 16)))


@pytest.mark.parametrize("gating", [True, False])
def test_spatial_pyramid_netvlad_matches_mpa_tpu(gating):
    tm = _check_module(JaxSpatialPyramidNetVLAD(output_dim=32, cluster_size=8, gating=gating),
                       lambda: SpatialPyramidNetVLAD(16, 32, 8, gating), _x(6, (4, 64, 16)))
    assert (tm.context_gating is not None) is gating


# -- the displacement kernels ----------------------------------------------------------


def _idx(seed, B, N, K):
    return np.random.default_rng(seed).integers(0, N, (B, N, K)).astype(np.int32)


def test_operator3d_matches_mpa_tpu():
    _check_module(JaxOperator3D(kernel_num=8, support_num=2), lambda: Operator3D(8, 2),
                  _idx(7, 2, 32, 6), _x(8, (2, 32, 3)), trains=False)


def test_operator_nd_matches_mpa_tpu():
    _check_module(JaxOperatorND(out_channel=8, support_num=3), lambda: OperatorND(5, 8, 3),
                  _idx(9, 2, 32, 6), _x(10, (2, 32, 3)), _x(11, (2, 32, 5)), trains=False)


def test_neighbor_pooling_matches_mpa_tpu():
    idx, feats = _idx(12, 2, 32, 6), _x(13, (2, 32, 7))
    want = JaxNeighborPooling().apply({}, jnp.asarray(idx), jnp.asarray(feats))
    got = NeighborPooling()(_t(idx), _t(feats))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("widths,support_num,k", [((8, 16, 24), 2, 6), ((32, 64, 128), 1, 16)])
def test_disp3d_encoder_matches_mpa_tpu(widths, support_num, k):
    x = _x(14, (2, 64, 3))
    assert_knn_apart([jnp.asarray(x)], k)
    tm = _check_module(JaxDisp3DEncoder(widths=widths, support_num=support_num, k=k),
                       lambda: Disp3DEncoder(widths, support_num, k), x, atol=1e-4)
    assert tm(_t(x)).shape == (2, 64, widths[-1])


# -- the raw parameters ----------------------------------------------------------------


def test_raw_parameters_carry_over_strictly_and_draw_as_flax():
    """A ``Disp3DEncoder``'s and a ``SpatialPyramidNetVLAD``'s flax
    variables load ``strict=True`` with no key left over, the raw leaves
    under their own names and shapes; ``init_like_flax`` draws them as
    ``mpa_tpu``'s initialisers do (``uniform(2 stdv)`` before the shift by
    ``-stdv``, ``normal(1 / sqrt(C))``)."""
    x = jnp.asarray(_x(15, (2, 64, 3)))
    flat = flax_variables(JaxDisp3DEncoder(widths=(8, 16), support_num=2, k=6), x)
    raw = {"params/op0/displacement": (3, 16), "params/op0/weights": (1, 1, 2, 8),
           "params/op1/displacement": (3, 32)}
    assert {k: flat[k].shape for k in raw} == raw and "params/op1/weights/kernel" in flat
    tm, unused = port(Disp3DEncoder((8, 16), 2, 6), flat)
    assert unused == []
    np.testing.assert_array_equal(tm.op0.weights.detach().numpy(), flat["params/op0/weights"])
    np.testing.assert_array_equal(tm.op1.weights.weight.detach().numpy(),
                                  flat["params/op1/weights/kernel"].T)
    vflat = flax_variables(JaxSpatialPyramidNetVLAD(output_dim=32, cluster_size=8),
                           jnp.asarray(_x(16, (2, 64, 16))))
    assert vflat["params/vlad0/cluster_weights2"].shape == (1, 16, 8)
    vm, unused = port(SpatialPyramidNetVLAD(16, 32, 8), vflat)
    assert unused == []
    np.testing.assert_array_equal(vm.vlad0.cluster_weights2.detach().numpy(),
                                  vflat["params/vlad0/cluster_weights2"])

    enc = init_like_flax(Disp3DEncoder((64, 256), 4, 6), torch.Generator().manual_seed(0))
    for p, stdv in ((enc.op0.displacement, 1 / 16), (enc.op0.weights, 1 / 16),
                    (enc.op1.displacement, 1 / np.sqrt(256 * 5))):
        p = p.detach()
        assert 0.0 <= float(p.min()) and float(p.max()) < 2 * stdv
        assert abs(float(p.mean()) - stdv) < 0.1 * stdv  # U[0, 2 stdv): mean stdv
    cw = init_like_flax(NetVLAD(64, 64), torch.Generator().manual_seed(0)).cluster_weights2
    cw = cw.detach()
    assert abs(float(cw.std()) - 1 / 8) < 0.01 and abs(float(cw.mean())) < 0.01
    again = init_like_flax(NetVLAD(64, 64), torch.Generator().manual_seed(0)).cluster_weights2
    assert torch.equal(cw, again)
