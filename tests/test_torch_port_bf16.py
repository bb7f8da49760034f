"""Port parity, mixed precision (``compute_dtype=bfloat16``), on the CPU.

The same numpy inputs go to ``mpa_tpu`` with ``jnp.bfloat16`` and to the
port with ``torch.bfloat16`` (its plain ops, the tensors lying on the CPU);
the float32 parameters go through ``from_jax_variables`` unchanged.

The comparator. ``mpa_tpu``'s CPU paths are not its TPU kernels: its
default CPU scatter-mean, the gather's VJP and the bias add's VJP sum bf16
values in bf16 (``segment_sum``, XLA's reduce), where the TPU kernels, and
the port, sum in float32 and round once. And XLA on the CPU, left to itself,
drops the roundings of a bf16 chain (``xla_allow_excess_precision``), which
``mpa_tpu``'s mixed precision keeps: every jitted ``mpa_tpu`` function here
is compiled with that option off (``jit_exact``), which gives what the
eager functions give.

- Ops: each of the five kernels' functions against ``mpa_tpu``'s Pallas
  kernels in interpret mode on the same bf16 inputs, as
  ``tests/test_pallas_kernels.py`` runs them: the gather bit for bit, the
  scatter-add bit for bit against ``scatter_add_rmw`` and a cast, the
  attention forward, the scatter-mean and both attention gradients within
  one bf16 ulp of their largest magnitude (the TPU backward rounds each edge
  gradient to bf16 before it adds, ``GRAD_SCATTER_PRECISION``; the port adds
  in float32); and every output and gradient dtype.
- Modules: ``LinearUnit`` with and without ``mid_op``, ``LocalTrans`` in
  both modes, ``LocalMerge`` with one, two and three branches and ``Fuse``,
  in eval and train mode, against ``mpa_tpu``'s CPU path: outputs and
  every parameter gradient within ``MODULE_ULPS`` bf16 ulps of each
  tensor's largest magnitude; the bias gradients ``mpa_tpu``'s CPU path
  sums in bf16 (``bf16_summed``) against its own output gradients summed in
  float32 in eval mode, and where they are zero up to rounding against the
  float32 gradient; the BatchNorm running statistics float32, and within
  ``MODULE_ULPS``.
- Whole models, ``markov_cls`` (seeds 7 and 8) and ``markov_partseg``
  (seeds 7-10) at narrow widths, every feature-space kNN of ``mpa_tpu``
  given the port's neighbours: the eval log-probs and the gradients of a
  train-mode loss. The port-bf16 against ``mpa_tpu``-bf16 gap is at most a
  share of the bf16-against-float32 gap, in the log-probs, per parameter
  (the rounding-zero tensors of ``chip_smoke.ROUNDING_ZERO`` apart, and the
  bf16-summed biases held as above) and over the whole gradient in L2: a
  quarter, but for part-seg's gradients (``PARTSEG_GAP_SHARE`` says which
  and why); cls gives the same argmax, part-seg the same point argmax at
  0.99 or more (``_model_runs`` and ``_partseg_gaps`` say which float32
  model and which scatter-mean).
"""

import os
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_cls import SMALL, _nest, _x, port  # noqa: E402
from test_torch_port_partseg import NARROW, _seg_inputs  # noqa: E402

from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier  # noqa: E402
from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu.nn import LinearUnit as JaxLinearUnit  # noqa: E402
from mpa_tpu.nn import LocalMerge as JaxLocalMerge  # noqa: E402
from mpa_tpu.nn import LocalTrans as JaxLocalTrans  # noqa: E402
from mpa_tpu.nn.fuse import Fuse as JaxFuse  # noqa: E402
from mpa_tpu.ops.pallas.attention_pallas import transition_attention as jax_attention  # noqa: E402
from mpa_tpu.ops.pallas.gather_pallas import gather_neighbors, scatter_add_rmw  # noqa: E402
from mpa_tpu.ops.scatter import scatter_mean_upsample as jax_scatter_mean  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier, MarkovPartSeg  # noqa: E402
from mpa_tpu_torch.nn import Fuse, LinearUnit, LocalMerge, LocalTrans  # noqa: E402
from mpa_tpu_torch.nn.keephigh_partseg import KeepHighResolutionPartSeg  # noqa: E402
from mpa_tpu_torch.ops import index_points, knn, scatter_mean_upsample, transition_attention  # noqa: E402
from mpa_tpu_torch.ops.attention import attention_fwd_form  # noqa: E402
from mpa_tpu_torch.ops.gather import scatter_add_form, scatter_add_plain  # noqa: E402
from mpa_tpu_torch.ops.scatter import scatter_mean_form  # noqa: E402
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402

BF = jnp.bfloat16
TBF = torch.bfloat16
# The modules' outputs and gradients: within this many bf16 ulps of each
# tensor's largest magnitude, in eval and in train mode (the two sides round
# at the same places; a float32 sum taken in another order can still round
# to the neighbouring bf16, and the next layer carries that on; in train
# mode the BatchNorm's batch statistics carry a row's difference to every
# row). Read: at most 1.25 in eval mode, 3.25 in train mode.
MODULE_ULPS = {False: 2.0, True: 4.0}


def jit_exact(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off, so that every
    bf16 rounding of ``mpa_tpu``'s mixed precision is kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def ulp(x: float) -> float:
    """A bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def in_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of want's largest magnitude."""
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / ulp(np.abs(want).max()))


def bf16_np(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 and widened back, so both sides see the same
    values."""
    return np.array(jnp.asarray(a).astype(BF).astype(jnp.float32))


def _bits(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# -- ops, against mpa_tpu's Pallas kernels in interpret mode ------------------------


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("N,E,W", [(300, 200, 64), (64, 40, 12), (1024, 256, 3)])
def test_gather_and_its_scatter_add_bit_for_bit(interpret, N, E, W):
    rng = np.random.default_rng(N + E)
    pts = bf16_np(rng.standard_normal((2, N, W)).astype(np.float32))
    idx = rng.integers(0, N, (2, E)).astype(np.int32)
    g = bf16_np(rng.standard_normal((2, E, W)).astype(np.float32))
    want = gather_neighbors(jnp.asarray(pts).astype(BF), jnp.asarray(idx))
    p = torch.from_numpy(pts).to(TBF).requires_grad_(True)
    got = index_points(p, torch.from_numpy(idx))
    assert got.dtype == TBF and want.dtype == BF
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The gather's VJP on the TPU: scatter_add_rmw's float32 sums, cast once.
    want_g = scatter_add_rmw(jnp.asarray(g).astype(BF), jnp.asarray(idx), N).astype(BF)
    got.backward(torch.from_numpy(g).to(TBF))
    assert p.grad.dtype == TBF
    np.testing.assert_array_equal(_bits(p.grad), _bits(want_g))
    np.testing.assert_array_equal(
        _bits(scatter_add_plain(torch.from_numpy(g).to(TBF), torch.from_numpy(idx), N)),
        _bits(want_g))


@pytest.mark.parametrize("B,S,K,N,C", [(2, 128, 8, 256, 32), (2, 512, 8, 1024, 16),
                                       (1, 60, 4, 100, 7)])
def test_scatter_mean_within_an_ulp(interpret, B, S, K, N, C):
    rng = np.random.default_rng(S + C)
    feats = bf16_np(rng.standard_normal((B, S, C)).astype(np.float32))
    idx = rng.integers(0, N, (B, S, K)).astype(np.int32)
    g = bf16_np(rng.standard_normal((B, N, C)).astype(np.float32))
    fj = jnp.asarray(feats).astype(BF)
    want, vjp = jax.vjp(lambda f: jax_scatter_mean(f, jnp.asarray(idx), N, use_pallas=True), fj)
    (want_g,) = vjp(jnp.asarray(g).astype(BF))
    f = torch.from_numpy(feats).to(TBF).requires_grad_(True)
    got = scatter_mean_upsample(f, torch.from_numpy(idx), N)
    got.backward(torch.from_numpy(g).to(TBF))
    assert got.dtype == TBF and want.dtype == BF and f.grad.dtype == TBF and want_g.dtype == BF
    assert in_ulps(got, want) <= 1.0
    assert in_ulps(f.grad, want_g) <= 1.0


# (n_branches, with_shift, N, S, K, c): N <= 512 takes _fused_small_fwd /
# _fused_small_bwd, above it _fwd_pallas / _bwd_scatter_pallas.
ATTENTION = [(1, True, 300, 100, 8, 16), (2, True, 256, 128, 8, 16), (2, True, 1024, 512, 8, 16),
             (1, False, 700, 300, 8, 16)]


@pytest.mark.parametrize("n_branches,with_shift,N,S,K,c", ATTENTION)
def test_attention_forward_and_gradients_within_an_ulp(interpret, n_branches, with_shift, N, S,
                                                       K, c):
    rng = np.random.default_rng(N + S + c)
    packed = rng.standard_normal((2, N, 2 * n_branches * c)).astype(np.float32)
    for r in range(n_branches):
        packed[..., 2 * r * c:(2 * r + 1) * c] = np.exp(packed[..., 2 * r * c:(2 * r + 1) * c])
    packed = bf16_np(packed)
    idx = rng.integers(0, N, (2, S, K)).astype(np.int32)
    shifts = bf16_np(rng.standard_normal((2, S, n_branches * c)).astype(np.float32))
    g = bf16_np(rng.standard_normal((2, S, n_branches * c)).astype(np.float32))
    pj = jnp.asarray(packed).astype(BF)
    sj = jnp.asarray(shifts).astype(BF) if with_shift else None

    def fj(p, s):
        return jax_attention(p, jnp.asarray(idx), s, n_branches, c, use_pallas=True)

    want, vjp = jax.vjp(fj, pj, sj)
    want_dp, want_ds = vjp(jnp.asarray(g).astype(BF))
    p = torch.from_numpy(packed).to(TBF).requires_grad_(True)
    s = torch.from_numpy(shifts).to(TBF).requires_grad_(True) if with_shift else None
    got = transition_attention(p, torch.from_numpy(idx), s, n_branches, c)
    got.backward(torch.from_numpy(g).to(TBF))
    assert got.dtype == TBF and want.dtype == BF
    assert p.grad.dtype == TBF and want_dp.dtype == BF
    assert in_ulps(got, want) <= 1.0
    assert in_ulps(p.grad, want_dp) <= 1.0
    if with_shift:
        assert s.grad.dtype == TBF and want_ds.dtype == BF
        assert in_ulps(s.grad, want_ds) <= 1.0


def _bf16_rows(shape, offset=0):
    """A contiguous bf16 view ``offset`` values into a fresh buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=TBF)[offset:].view(shape)


@pytest.mark.parametrize("width,offset,vec", [(64, 0, 8), (24, 0, 8), (12, 0, 4), (64, 4, 4),
                                              (64, 2, 1), (64, 1, 1), (7, 0, 1)])
def test_bf16_channel_forms(width, offset, vec):
    """The channels a thread or lane that the attention forward, the
    scatter-mean and the scatter-add take on bf16 rows: eight (one 16-byte
    load) where they divide the width and the rows start on 16 bytes, four
    (8 bytes), else one; the scatter-add two where the width is even and
    the rows start on 4 bytes. float32 keeps four and one."""
    rows = _bf16_rows((2, 300, width), offset)
    packed = _bf16_rows((2, 300, 2 * 2 * width), offset)
    shifts = _bf16_rows((2, 100, 2 * width), offset)
    assert attention_fwd_form(packed, shifts, 8, width) == vec
    assert attention_fwd_form(packed, shifts, 32, width) == 1  # more rows than registers hold
    assert scatter_mean_form(rows, 500)[1] == vec
    pair = 2 if vec == 1 and width % 2 == 0 and offset % 2 == 0 else vec
    assert scatter_add_form(rows, 500)[1] == pair
    f32 = rows.float()
    assert scatter_mean_form(f32, 500)[1] == (4 if width % 4 == 0 else 1)
    assert attention_fwd_form(packed.float(), shifts.float(), 8, width) == (
        4 if width % 4 == 0 else 1)


def test_knn_upcasts_bf16_features():
    """The feature kNN of bf16 rows: float32 distances of the widened rows,
    so the same neighbours as the float32 search on those values."""
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.standard_normal((2, 64, 16)).astype(np.float32)).to(TBF)
    query = base[:, ::4]
    d16, i16 = knn(8, base, query)
    d32, i32 = knn(8, base.float(), query.float())
    assert d16.dtype == torch.float32
    assert torch.equal(i16, i32) and torch.equal(d16, d32)


# -- modules, against mpa_tpu's CPU path ---------------------------------------------

# The Dense biases of bf16 layers: their gradient is a sum over every row of
# the layer's bf16 output gradient, which mpa_tpu's CPU path takes in bf16
# and the port in float32 (rounded once). In eval mode they are held to
# mpa_tpu's own output gradients summed in float32 (``cotangent_probe``),
# within MODULE_ULPS (read: at most 1.94). In train mode a BatchNorm follows
# most of these layers and their gradients are zero up to rounding, as the
# k and q biases' are in both modes (ATTENTION_ZERO), and a sum of rows of
# both signs can move by more than its own size in bf16: those are held
# against the float32 gradient (the port's float32 module's, which the
# float32 tests hold to mpa_tpu's within 1e-5), no farther from it than
# mpa_tpu's bf16 one, up to BIAS_SLACK (read: at most 1.31).
BF16_SUMMED = ("linear.bias", ".k.bias", ".v.bias", ".q.bias")
# Zero up to rounding in either mode: a shift of k cancels in the
# attention's normalisation, and q has no part in its output.
ATTENTION_ZERO = ("k.bias", "q.bias")
BIAS_SLACK = 1.5


def bf16_summed(name: str) -> bool:
    return name.endswith(BF16_SUMMED) or name in ("k.bias", "v.bias", "q.bias")


def cotangent_probe():
    """A flax method interceptor that passes the output of every bf16
    ``nn.Dense`` call through ``perturb`` (``cotangent<i>``, the module's
    i-th call), so that the gradient with respect to the perturbations is
    each output's own gradient, before any sum."""
    calls = {}

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        y = next_fun(*args, **kwargs)
        if not (isinstance(mod, flax_nn.Dense) and context.method_name == "__call__"
                and mod.dtype == BF):
            return y
        key = mod.scope.path
        calls[key] = calls.get(key, 0) + 1
        return mod.perturb(f"cotangent{calls[key] - 1}", y)

    return interceptor


def _jax_side(jm, flat, args, kw, train, w, pick):
    """Output, parameter gradients and BatchNorm statistics of ``jm`` for the
    loss ``sum(pick(out) * w)``, through ``jit_exact``; in eval mode also,
    as ``params/<dense>/bias``, each bf16 Dense's output gradients summed in
    float32 over every row of every call (the bias gradient the TPU's
    float32 sums give; mpa_tpu's CPU path sums in bf16)."""
    v = _nest(flat)
    variables = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}

    def probed(params, cotangents):
        with flax_nn.intercept_methods(cotangent_probe()):
            return jm.apply(dict(variables, params=params, perturbations=cotangents), *args,
                            train=False, **kw)

    def loss(params, cotangents):
        if train:
            out, upd = jm.apply(dict(variables, params=params), *args, train=True,
                                mutable=["batch_stats"], **kw)
        else:
            out, upd = probed(params, cotangents), {}
        out = pick(out)
        return jnp.sum(out.astype(jnp.float32) * w), (out, upd)

    cotangents = {}
    if not train:
        with flax_nn.intercept_methods(cotangent_probe()):
            shapes = jax.eval_shape(lambda p: jm.apply(dict(variables, params=p), *args,
                                                       train=False, mutable=["perturbations"],
                                                       **kw)[1], v["params"])
        cotangents = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                            shapes["perturbations"])
    (_, (out, upd)), (grads, cots) = jit_exact(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), v["params"], cotangents)
    flat_g = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        flat_g["params/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(upd))[0]:
        flat_g["/".join(p.key for p in path)] = np.asarray(leaf)
    bias_sums = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(cots)[0]:
        key = "params/" + "/".join(p.key for p in path[:-1]) + "/bias"
        rows = np.asarray(leaf.astype(jnp.float32)).reshape(-1, leaf.shape[-1])
        bias_sums[key] = bias_sums.get(key, 0.0) + rows.sum(0, dtype=np.float64)
    return out, flat_g, {k: v.astype(np.float32) for k, v in bias_sums.items()}


def _port_side(tm, args, kw, train, w, pick):
    tm.train(train)
    out = pick(tm(*args, **kw))
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in tm.parameters())
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in tm.named_parameters()}
    stats = {n: b.numpy() for n, b in tm.named_buffers() if "running" in n}
    return out, grads, stats


def jax_variables_jit(module, static, args, seed=0, **kw):
    """``test_torch_port_cls.jax_variables`` with the init jitted (flax's
    eager init of a Fuse takes tens of seconds); ``static`` lead ``args``."""
    variables = jax.jit(lambda key, a: module.init(key, *static, *a, train=False, **kw))(
        jax.random.key(seed), args)
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(dict(variables))[0]:
        key = "/".join(p.key for p in path)
        leafname = key.rsplit("/", 1)[-1]
        v = np.asarray(leaf)
        if leafname in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leafname in ("bias", "mean"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        flat[key] = v
    return flat


def _widen(x):
    """``x`` (a tensor, or lists, tuples and dicts of them) with its bf16
    tensors widened to float32."""
    if torch.is_tensor(x):
        return x.float() if x.dtype == TBF else x
    if isinstance(x, (list, tuple)):
        return type(x)(_widen(v) for v in x)
    if isinstance(x, dict):
        return {k: _widen(v) for k, v in x.items()}
    return x


def compare_module(jm, tm_ctor, jargs, targs, train, jkw=None, tkw=None,
                   pick=lambda o: o, seed=0):
    """``jm`` (flax, bf16) and the port's ``tm_ctor(dtype)`` (bf16) on the
    same inputs: the output within ``MODULE_ULPS``, every parameter gradient
    within ``MODULE_ULPS`` (the bf16-summed biases against ``mpa_tpu``'s
    output gradients summed in float32 in eval mode, against the float32
    gradient in train mode), the running statistics float32 and, as
    statistics of bf16 rows, within ``MODULE_ULPS`` bf16 ulps too. Returns
    the readings."""
    jkw, tkw = jkw or {}, tkw or {}
    ulps = MODULE_ULPS[train]
    static = [a for a in jargs if isinstance(a, int)]  # Fuse's target leads
    arrays = tuple(a for a in jargs if not isinstance(a, int))
    flat = jax_variables_jit(jm.clone(dtype=None), static, arrays, seed=seed, **jkw)
    tm, unused = port(tm_ctor(TBF), flat)
    assert unused == []
    t32, _ = port(tm_ctor(None), flat)
    tm.train(train)
    out_shape = pick(tm(*targs, **tkw)).shape
    w = np.random.default_rng(seed + 1).standard_normal(tuple(out_shape)).astype(np.float32)
    tm, _ = port(tm_ctor(TBF), flat)  # fresh running statistics
    want, jg, bias_sums = _jax_side(jm, flat, jargs, jkw, train, w, pick)
    got, tg, stats = _port_side(tm, targs, tkw, train, w, pick)
    _, tg32, _ = _port_side(t32, _widen(targs), _widen(tkw), train, w, pick)
    assert got.dtype == TBF and want.dtype == BF
    readings = {"out": in_ulps(got, want)}
    conv = {k: v.numpy() for k, v in from_jax_variables(
        {k: v for k, v in jg.items() if k.startswith("params/")}, tm)[0].items()}
    summed = {}
    if not train:
        summed = {k: v.numpy() for k, v in from_jax_variables(bias_sums, tm)[0].items()}
        assert sorted(summed) == sorted(n for n in tg if bf16_summed(n)), sorted(summed)
        summed = {n: v for n, v in summed.items() if not n.endswith(ATTENTION_ZERO)}
        conv.update(summed)
    for name, g in tg.items():
        if bf16_summed(name) and name not in summed:
            port_err = np.linalg.norm(g - tg32[name])
            jax_err = np.linalg.norm(conv[name] - tg32[name])
            readings[name] = port_err / max(jax_err, 1e-30) if port_err > 0 else 0.0
            assert port_err <= BIAS_SLACK * jax_err + 1e-6 * np.linalg.norm(tg32[name]), \
                (name, port_err, jax_err)
        else:
            readings[name] = in_ulps(g, conv[name])
            assert readings[name] <= ulps, (name, readings[name])
    assert readings["out"] <= ulps, readings["out"]
    if train:
        want_stats = from_jax_variables({k: v for k, v in jg.items()
                                         if k.startswith("batch_stats/")}, tm)[0]
        for name, s in stats.items():
            assert s.dtype == np.float32
            readings[name] = in_ulps(s, want_stats[name].numpy())
            assert readings[name] <= ulps, (name, readings[name])
    return readings


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mid", [False, True])
def test_linear_unit(train, mid):
    B, S, K, N = 2, 12, 4, 24
    x = _x(0, (B, S, 6))
    idx = np.random.default_rng(3).integers(0, N, (B, S, K)).astype(np.int32)
    jkw = {"mid_op": lambda y: jax_scatter_mean(y, jnp.asarray(idx), N)} if mid else {}
    tkw = {"mid_op": lambda y: scatter_mean_upsample(y, torch.from_numpy(idx), N)} if mid else {}
    compare_module(JaxLinearUnit(10, dtype=BF), lambda dt: LinearUnit(6, 10, dtype=dt),
                   (jnp.asarray(x),), (torch.from_numpy(x),), train, jkw, tkw)


def test_linear_unit_without_norm():
    """No norm: flax's LeakyReLU runs on the bf16 Dense output, its slope a
    bf16 weak scalar (``nn/linear.py::leaky_relu``)."""
    x = _x(5, (2, 12, 6))
    compare_module(JaxLinearUnit(10, norm=None, dtype=BF),
                   lambda dt: LinearUnit(6, 10, norm=None, dtype=dt),
                   (jnp.asarray(x),), (torch.from_numpy(x),), False)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("xyz_mode,residual_proj", [(True, True), (False, False), (False, True)])
def test_local_trans(train, xyz_mode, residual_proj):
    B, N, S, K, C_out = 2, 32, 12, 8, 16
    C_in = 3 if xyz_mode else (10 if residual_proj else C_out)
    source = _x(1, (B, N, C_in))
    if not xyz_mode:
        source = bf16_np(source)
    center = source[:, :S]
    idx = np.random.default_rng(2).integers(0, N, (B, S, K)).astype(np.int32)
    cast = (lambda a: a) if xyz_mode else (lambda a: a.astype(BF))
    tcast = (lambda a: a) if xyz_mode else (lambda a: a.to(TBF))
    jargs = (cast(jnp.asarray(source)), cast(jnp.asarray(center)), jnp.asarray(idx))
    targs = (tcast(torch.from_numpy(source)), tcast(torch.from_numpy(center)),
             torch.from_numpy(idx))
    compare_module(JaxLocalTrans(C_out, K, residual_proj=residual_proj, dtype=BF),
                   lambda dt: LocalTrans(C_in, C_out, K, residual_proj=residual_proj, dtype=dt),
                   jargs, targs, train, {"xyz_mode": xyz_mode}, {"xyz_mode": xyz_mode})


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("branches", [2, 3])
def test_local_merge(train, branches):
    rng = np.random.default_rng(4 + branches)
    fine = rng.standard_normal((2, 48, 3)).astype(np.float32)
    fps = np.stack([np.arange(0, 48, 2)] * 2).astype(np.int32)
    coarse = np.take_along_axis(fine, fps[..., None].astype(np.int64), 1)
    feat = bf16_np(rng.standard_normal((2, 48, 16)).astype(np.float32))
    kw = dict(include_xyz_branch=branches == 3)
    jargs = (jnp.asarray(coarse), jnp.asarray(fine))
    targs = (torch.from_numpy(coarse), torch.from_numpy(fine))
    jkw = dict(feature=jnp.asarray(feat).astype(BF), fps_idx=jnp.asarray(fps))
    tkw = dict(feature=torch.from_numpy(feat).to(TBF), fps_idx=torch.from_numpy(fps))
    compare_module(JaxLocalMerge(16, 8, residual=True, dtype=BF, **kw),
                   lambda dt: LocalMerge(16, 16, 8, True, dtype=dt, **kw),
                   jargs, targs, train, jkw, tkw, pick=lambda o: o[0])


def test_local_merge_first_state():
    xyz = _x(3, (2, 48, 3))
    compare_module(JaxLocalMerge(16, 8, residual=True, dtype=BF),
                   lambda dt: LocalMerge(None, 16, 8, True, dtype=dt),
                   (jnp.asarray(xyz), jnp.asarray(xyz)),
                   (torch.from_numpy(xyz), torch.from_numpy(xyz)), True, pick=lambda o: o[0])


@pytest.mark.parametrize("train", [False, True])
def test_fuse(train, target=2):
    """Target 2: two finer sources gathered, two coarser ones scattered."""
    from test_torch_port_partseg import _ladder

    sizes, ch = (64, 32, 16, 8, 4), (8, 8, 8, 16, 32)
    xyz, feats, fps, knn_idx = _ladder(sizes, ch, seed=3)
    feats = [bf16_np(f) for f in feats]
    j = lambda xs: [None if x is None else jnp.asarray(x) for x in xs]  # noqa: E731
    t = lambda xs: [None if x is None else torch.from_numpy(x) for x in xs]  # noqa: E731
    jf = [jnp.asarray(f).astype(BF) for f in feats]
    tf = [torch.from_numpy(f).to(TBF) for f in feats]
    compare_module(JaxFuse(ch, num_neighbors=8, dtype=BF), lambda dt: Fuse(ch, target, 8, dtype=dt),
                   (target, jf, j(fps), j(knn_idx), j(xyz)), (tf, t(fps), t(knn_idx), t(xyz)),
                   train, pick=lambda o: o[target] if isinstance(o, list) else o, seed=target)


# -- whole models --------------------------------------------------------------------

# The whole models: the port-bf16 against mpa_tpu-bf16 gap over mpa_tpu's
# own bf16-against-float32 gap, at most: in the log-probs, over the whole
# gradient and in each parameter's gradient (the rounding-zero and
# bf16-summed ones apart), at each seed, with the feature neighbours pinned
# (``_model_runs``). cls holds a quarter everywhere (read at seeds 7 and 8:
# logp 0.081, whole gradient 0.013, per parameter 0.025). Part-seg's
# train-mode gradients sit at a floor that mpa_tpu itself does not keep
# below a quarter: against itself with its matmuls' float32 sums taken in
# another order (each bf16 product split in two halves) it reads, at seeds
# 7-10, logp up to 0.78, whole gradient up to 0.17, per parameter up to
# 0.47 (the max over the neighbours and the train-mode BatchNorms over 2-32
# rows amplify single roundings; conv7 normalises two rows, so its weight
# gradient moves by half its norm under any rounding). The port reads logp
# up to 0.17, whole gradient up to 0.27 (0.21 pooled over the four steps),
# per parameter up to 1.0 (conv7 at seed 10). So part-seg holds a quarter in
# the log-probs and over the whole gradient pooled over the seeds, half at
# each seed, and 1.5 in each parameter: a gradient lost or misrouted reads
# far above that.
CLS_GAP_SHARE = {"logp": 0.25, "grads_l2": 0.25, "param": 0.25}
PARTSEG_GAP_SHARE = {"logp": 0.25, "grads_l2": 0.5, "grads_l2_pooled": 0.25, "param": 1.5}


def _feature_search(base) -> bool:
    """A kNN over feature rows, not over xyz (every feature width here is
    16 or more)."""
    return base.shape[-1] != 3


class _PinnedKnn:
    """``local_merge.knn`` of the port (``module``) with each feature search
    either recorded (``pins`` None: its indices appended to ``self.pins``)
    or given the next of ``pins`` in call order."""

    def __init__(self, module, pins=None):
        self.module, self.real = module, module.knn
        self.record = pins is None
        self.pins = [] if pins is None else list(pins)
        self.next = 0

    def __call__(self, k, base, query):
        dist, idx = self.real(k, base, query)
        if not _feature_search(base):
            return dist, idx
        if self.record:
            self.pins.append(idx.clone())
            return dist, idx
        pin = self.pins[self.next]
        self.next += 1
        assert pin.shape == idx.shape, (pin.shape, idx.shape)
        return dist, pin

    def __enter__(self):
        self.module.knn = self
        return self

    def __exit__(self, *exc):
        self.module.knn = self.real
        assert self.record or exc[0] is not None or self.next == len(self.pins), \
            (self.next, len(self.pins))


# name -> (variables, mpa_tpu's bf16 run compiled), shared by the seeds of a
# model: the inputs and the pinned neighbours are arguments.
_COMPILED = {}


def _model_runs(name, jm_ctor, tm_ctor, jx, tx, w_train):
    """The port in bf16, the port in float32 and ``mpa_tpu`` in bf16, from
    the same variables (seed 0): eval log-probs, and the gradients of
    ``sum(log-probs * w_train)`` in train mode (dropout 0). Every
    feature-space kNN of ``mpa_tpu`` takes the neighbours the port's bf16
    model found (recorded in call order, eval forward then train forward):
    the bf16 rows of the two sides rank a near tie in another order now and
    then, and that flip, not the arithmetic, would set the gap (the spatial
    searches on float32 xyz agree anyway). The float32 model finds its own,
    as ``mpa_tpu``'s float32 model would. The port's float32 model stands
    for ``mpa_tpu``'s: the float32 tests hold the two within 1e-4 in
    log-probs and gradients (``test_torch_port_cls.py``,
    ``test_torch_port_partseg.py``, ``test_torch_port_train.py``), far
    inside the bf16 gaps measured here, and one jitted JAX model fewer keeps
    this file's time down."""
    import mpa_tpu.nn.local_merge as jax_local_merge
    import mpa_tpu_torch.nn.local_merge as port_local_merge

    if name not in _COMPILED:
        _COMPILED[name] = (jax_variables_jit(jm_ctor(None), [], (jx,), seed=0), None)
    flat, compiled = _COMPILED[name]
    out = {}
    for dt in (TBF, None):
        tm, unused = port(tm_ctor(dt), flat)
        assert unused == []
        with _PinnedKnn(port_local_merge) as pinned:
            with torch.no_grad():
                lp = tm(tx)
            assert lp.dtype == torch.float32
            tm.train()
            (tm(tx) * torch.from_numpy(w_train)).sum().backward()
        pins = pinned.pins if dt else pins
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        out["bf16" if dt else "f32"] = (
            lp.numpy(), {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                         for n, p in tm.named_parameters()})
    assert pins, "no feature-space kNN was pinned"
    jm = jm_ctor(BF)

    def run(params, batch_stats, x, w, pinned):
        left = list(pinned)
        real = jax_local_merge.knn

        def knn_pinned(k, base, query):
            dist, idx = real(k, base, query)
            if not _feature_search(base):
                return dist, idx
            pin = left.pop(0)
            assert pin.shape == idx.shape, (pin.shape, idx.shape)
            return dist, pin.astype(idx.dtype)

        jax_local_merge.knn = knn_pinned
        try:
            lp_eval = jm.apply({"params": params, "batch_stats": batch_stats}, x, train=False)

            def loss(p):
                lp, _ = jm.apply({"params": p, "batch_stats": batch_stats}, x, train=True,
                                 mutable=["batch_stats"])
                return jnp.sum(lp * w)

            grads = jax.grad(loss)(params)
        finally:
            jax_local_merge.knn = real
        assert not left, f"{len(left)} pinned searches not made"
        return lp_eval, grads

    v = _nest(flat)
    args = (v["params"], v["batch_stats"], jx, jnp.asarray(w_train),
            [jnp.asarray(p.numpy().astype(np.int32)) for p in pins])
    if compiled is None:
        compiled = jax.jit(run).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        _COMPILED[name] = (flat, compiled)
    jlp, jgrads = compiled(*args)
    flat_g = {"params/" + "/".join(p.key for p in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    conv = {n: t.numpy() for n, t in from_jax_variables(flat_g, tm)[0].items()}
    return out, np.asarray(jlp), conv


def _gaps(out, jlp, jgrads) -> dict:
    """The gaps of ``_model_runs``' results: each as ``(port-bf16 against
    mpa_tpu-bf16, float32 against mpa_tpu-bf16)``: the log-probs' largest,
    the whole gradient's L2, and each parameter's L2."""
    (lp, grads), (lp32, grads32) = out["bf16"], out["f32"]
    l2 = lambda a, ns: float(np.sqrt(sum(np.sum((a[n] - jgrads[n]) ** 2) for n in ns)))  # noqa: E731
    gaps = {"logp": (float(np.abs(lp - jlp).max()), float(np.abs(jlp - lp32).max())),
            "grads_l2": (l2(grads, grads), l2(grads32, grads))}
    gaps["params"] = {n: (l2(grads, [n]), l2(grads32, [n]), float(np.linalg.norm(g - grads32[n])))
                      for n, g in grads.items()}
    return gaps


def _hold_model(gaps: dict, share: dict) -> dict:
    """The criteria of ``share`` on one seed's ``_gaps``: the
    log-probs, the whole gradient and each parameter's (the rounding-zero
    ones of ``chip_smoke.ROUNDING_ZERO`` apart, and the bf16-summed biases
    held against the float32 gradient, within ``BIAS_SLACK`` of mpa_tpu's
    distance from it); returns the readings."""
    import chip_smoke

    readings = {k: gaps[k][0] / gaps[k][1] for k in ("logp", "grads_l2")}
    for k in readings:
        assert readings[k] <= share[k], readings
    for n, (port_gap, ref, from_f32) in gaps["params"].items():
        if chip_smoke.ROUNDING_ZERO.search(n):
            continue  # zero up to rounding: both gaps are rounding
        if bf16_summed(n):
            readings[n] = from_f32 / ref
            assert readings[n] <= BIAS_SLACK, (n, readings[n])
        else:
            readings[n] = port_gap / ref
            assert readings[n] <= share["param"], (n, readings[n])
    return readings


def _cls_gaps(seed):
    x = _x(seed, (4, 128, 3))
    w = np.random.default_rng(seed + 1).standard_normal((4, 15)).astype(np.float32)
    out, jlp, jgrads = _model_runs(
        "cls", lambda dt: JaxMarkovClassifier(num_classes=15, dropout=0.0, compute_dtype=dt, **SMALL),
        lambda dt: MarkovClassifier(num_classes=15, dropout=0.0, compute_dtype=dt, **SMALL),
        jnp.asarray(x), torch.from_numpy(x), w)
    np.testing.assert_array_equal(out["bf16"][0].argmax(-1), jlp.argmax(-1))
    return _gaps(out, jlp, jgrads)


def _partseg_gaps(monkeypatch, seed):
    """``mpa_tpu``'s decoder scatter-means take its TPU contract here, the
    float32 sums of its Pallas kernel rounded once: its own
    ``scatter_mean_upsample`` on the widened features, cast back (its CPU
    default sums and counts in bf16, ``mpa_tpu/ops/scatter.py:53-60``, and
    moves the median log-prob by about as much as bf16 itself does)."""
    import mpa_tpu.nn.window_mode as jax_window_mode

    monkeypatch.setattr(jax_window_mode, "scatter_mean_upsample",
                        lambda f, i, n: jax_scatter_mean(f.astype(jnp.float32), i, n).astype(f.dtype))
    x, onehot = _seg_inputs(seed)
    w = np.random.default_rng(seed + 2).standard_normal((2, 256, 50)).astype(np.float32)
    out, jlp, jgrads = _model_runs(
        "partseg", lambda dt: JaxMarkovPartSeg(dropout=0.0, compute_dtype=dt, **NARROW),
        lambda dt: MarkovPartSeg(dropout=0.0, compute_dtype=dt, **NARROW),
        (jnp.asarray(x), jnp.asarray(onehot)), (torch.from_numpy(x), torch.from_numpy(onehot)), w)
    assert (out["bf16"][0].argmax(-1) == jlp.argmax(-1)).mean() >= 0.99
    return _gaps(out, jlp, jgrads)


PARTSEG_SEEDS = [7, 8, 9, 10]


@pytest.mark.parametrize("seed", [7, 8])
def test_markov_cls_bf16_against_mpa_tpu(seed):
    _hold_model(_cls_gaps(seed), CLS_GAP_SHARE)


@pytest.mark.parametrize("seed", PARTSEG_SEEDS)
def test_markov_partseg_bf16_against_mpa_tpu(monkeypatch, seed):
    _hold_model(_partseg_gaps(monkeypatch, seed), PARTSEG_GAP_SHARE)


def test_markov_partseg_bf16_gradient_gap_over_the_seeds(monkeypatch):
    """The whole gradient's gap pooled over ``PARTSEG_SEEDS``: the port's
    distance from mpa_tpu over all four steps against float32's."""
    gaps = [_partseg_gaps(monkeypatch, seed)["grads_l2"] for seed in PARTSEG_SEEDS]
    pooled = np.sqrt(sum(g ** 2 for g, _ in gaps)) / np.sqrt(sum(r ** 2 for _, r in gaps))
    assert pooled <= PARTSEG_GAP_SHARE["grads_l2_pooled"], pooled


# -- what the mixed precision refuses, and the launch counts ------------------------


def test_window_modes_and_other_dtypes_refuse():
    """The window modes take ``compute_dtype`` (bf16 storage in the windowed
    kernels is ported: ``tests/test_torch_port_bf16_window.py``) and the
    windowed ops keep bf16 rows bf16; a compute dtype other than bf16 is
    refused, and so are bf16 ``packed`` with float32 ``shifts``."""
    from mpa_tpu_torch.ops.window import (
        make_window_spec, windowed_scatter_mean, windowed_transition_attention,
    )

    for mode in ("window", "window_all"):
        keep = KeepHighResolutionPartSeg(dtype=TBF, neighbor_mode=mode)
        assert keep.windowed and keep.la2.feature_trans2.dtype == TBF
    spec = make_window_spec(64, 128)
    packed = torch.ones((1, 128, 32), dtype=TBF)
    idx = torch.zeros((1, 64, 8), dtype=torch.int32)
    assert windowed_transition_attention(packed, idx, None, 1, 16, spec).dtype == TBF
    assert windowed_scatter_mean(torch.ones((1, 64, 16), dtype=TBF), idx, 128, spec).dtype == TBF
    with pytest.raises(ValueError, match="bf16 shifts"):
        windowed_transition_attention(packed, idx, torch.zeros((1, 64, 16)), 1, 16, spec)
    for dt in (torch.float16, torch.float32):
        with pytest.raises(ValueError, match="compute_dtype"):
            MarkovClassifier(compute_dtype=dt)
        with pytest.raises(ValueError, match="compute_dtype"):
            MarkovPartSeg(compute_dtype=dt)
        with pytest.raises(ValueError, match="compute_dtype"):
            MarkovPartSeg(compute_dtype=dt, neighbor_mode="window")


def test_activation_dtypes_and_no_launch_on_the_cpu():
    """Where the bf16 classifier's activations are bf16 and where float32,
    read from its modules' outputs; on the CPU no kernel is launched, in
    either count."""
    model = MarkovClassifier(num_classes=15, dropout=0.0, compute_dtype=TBF, **SMALL).eval()
    seen = {}
    def record(name):
        def hook(module, args, out):
            seen[name] = (out[0] if isinstance(out, tuple) else out).dtype
        return hook

    for name in ("keep_high.la0", "keep_high.la1", "keep_high.conv4", "keep_high.final_bn",
                 "fc1"):
        model.get_submodule(name).register_forward_hook(record(name))
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = model(torch.from_numpy(_x(3, (2, 128, 3))))
    assert out.dtype == torch.float32
    assert seen == {"keep_high.la0": TBF, "keep_high.la1": TBF, "keep_high.conv4": TBF,
                    "keep_high.final_bn": torch.float32, "fc1": torch.float32}
    assert not any(kernels.LAUNCHES.values()) and not any(kernels.LAUNCHES_BF16.values())
