"""Port parity, mixed precision in the Morton-window modes, on the CPU.

``markov_partseg`` with ``compute_dtype=bfloat16`` in ``window`` and
``window_all``, and the three windowed ops it runs in bf16: the same numpy
inputs go to ``mpa_tpu`` with ``jnp.bfloat16`` and to the port with
``torch.bfloat16`` (its plain ops: the tensors lie on the CPU). Also
``LinearUnit(act=)`` and ``PointNetFeaturePropagation(act=)``.

``mpa_tpu`` is held to its TPU contract, not to its CPU fallbacks, which
differ in bf16:

- the windowed attention and scatter-mean run ``mpa_tpu``'s Pallas kernels
  (``_wattn``, ``_wscatter_mean``) in interpret mode, as
  ``tests/test_window_attention.py`` runs them;
- in the whole models, ``mpa_tpu``'s CPU ``windowed_scatter_mean`` falls
  back to ``scatter_mean_upsample``, which sums and counts in bf16
  (``mpa_tpu/ops/scatter.py:53-60``) where the TPU kernel sums in float32
  (``window_attention.py:581``): the test patches it with the float32 sums
  rounded once; and ``mpa_tpu``'s CPU windowed kNN
  (``windowed_knn_reference``) takes distances in the features' type where
  its TPU kernel widens them to float32 (``:166-168``): the test gives it the
  widened rows. Both patches live in this file only.

Tolerances. The ops: within one bf16 ulp of each output's largest magnitude,
as ``tests/test_torch_port_bf16.py`` holds the exact ops (the two sides
round at the same places; a float32 sum taken in another order can round to
the neighbouring bf16, and the TPU backward rounds each edge gradient to
bf16 before its adds, ``GRAD_SCATTER_PRECISION``, where the port adds in
float32). The windowed kNN of bf16 rows: the indices of the float32 search
on the widened rows, bit for bit. The models: the gap-share method of
``tests/test_torch_port_bf16.py`` (``_hold_model``, ``PARTSEG_GAP_SHARE``),
the feature-space neighbours of ``mpa_tpu`` pinned to the port's.
``act``: within 1e-5 (float32).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_bf16 import (  # noqa: E402  (pins torch's threads)
    BF, PARTSEG_GAP_SHARE, TBF, _feature_search, _gaps, _hold_model, bf16_np, in_ulps,
    interpret, jax_variables_jit,  # noqa: F401  (interpret: the fixture)
)
from test_torch_port_cls import _nest, _x, jax_variables, port  # noqa: E402
from test_torch_port_partseg import NARROW, _seg_inputs  # noqa: E402
from test_torch_port_window import ATTENTION_CASES, _attention_case, _sorted_pair  # noqa: E402

from mpa_tpu.models import MarkovPartSeg as JaxMarkovPartSeg  # noqa: E402
from mpa_tpu.nn import LinearUnit as JaxLinearUnit  # noqa: E402
from mpa_tpu.nn.feature_propagation import (  # noqa: E402
    PointNetFeaturePropagation as JaxFeaturePropagation,
)
from mpa_tpu.ops.pallas import window_attention as JWA  # noqa: E402
from mpa_tpu.ops.scatter import scatter_mean_upsample as jax_scatter_mean  # noqa: E402
from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.models import MarkovPartSeg  # noqa: E402
from mpa_tpu_torch.nn import LinearUnit, PointNetFeaturePropagation  # noqa: E402
from mpa_tpu_torch.ops import window as W  # noqa: E402
from mpa_tpu_torch.utils import from_jax_variables  # noqa: E402

# -- the windowed ops, against mpa_tpu's Pallas kernels in interpret mode ------------


@pytest.mark.parametrize("n_branches,C,with_shifts,S,N", ATTENTION_CASES)
def test_windowed_attention_bf16_within_an_ulp(n_branches, C, with_shifts, S, N, interpret):
    """Forward and both gradients of bf16 ``packed`` and ``shifts`` against
    ``_wattn`` (``use_pallas=True``): bf16 in, bf16 out, one ulp."""
    spec, jspec, packed, idx, shifts, gctx = _attention_case(S + C, S, N, n_branches, C,
                                                             with_shifts)
    packed, gctx = bf16_np(packed), bf16_np(gctx)
    shifts = bf16_np(shifts) if with_shifts else None
    j = lambda a: None if a is None else jnp.asarray(a).astype(BF)  # noqa: E731

    def fj(p, s):
        return JWA.windowed_transition_attention(p, jnp.asarray(idx), s, n_branches, C, jspec,
                                                 use_pallas=True)

    want, vjp = jax.vjp(fj, j(packed), j(shifts))
    want_dp, want_ds = vjp(j(gctx))
    p = torch.from_numpy(packed).to(TBF).requires_grad_(True)
    s = torch.from_numpy(shifts).to(TBF).requires_grad_(True) if with_shifts else None
    got = W.windowed_transition_attention(p, torch.from_numpy(idx), s, n_branches, C, spec)
    got.backward(torch.from_numpy(gctx).to(TBF))
    assert got.dtype == TBF and want.dtype == BF
    assert p.grad.dtype == TBF and want_dp.dtype == BF
    assert in_ulps(got, want) <= 1.0
    assert in_ulps(p.grad, want_dp) <= 1.0
    if with_shifts:
        assert s.grad.dtype == TBF and want_ds.dtype == BF
        assert in_ulps(s.grad, want_ds) <= 1.0


@pytest.mark.parametrize("S,N,sq", [(128, 128, 32), (64, 256, 16), (256, 64, 32), (32, 512, 16)])
def test_windowed_scatter_mean_bf16_within_an_ulp(S, N, sq, interpret):
    """bf16 features against ``_wscatter_mean`` (``use_pallas=True``): the
    float32 sums of the kernel rounded once, and ``_wscatter_bwd``'s
    float32 gather of the gradient over the count, summed over K and
    rounded once; an unclaimed slot stays zero."""
    fine, coarse = _sorted_pair(S * 7 + N, 2, S, N, dup=True)
    spec, jspec = W.make_window_spec(S, N, sq), JWA.make_window_spec(S, N, sq)
    idx = np.asarray(JWA.windowed_knn_reference(4, jnp.asarray(fine), jnp.asarray(coarse), jspec))
    rng = np.random.default_rng(S)
    feats = bf16_np(rng.standard_normal((2, S, 16)).astype(np.float32))
    g = bf16_np(rng.standard_normal((2, N, 16)).astype(np.float32))
    want, vjp = jax.vjp(lambda f: JWA.windowed_scatter_mean(f, jnp.asarray(idx), N, jspec,
                                                            use_pallas=True),
                        jnp.asarray(feats).astype(BF))
    (want_g,) = vjp(jnp.asarray(g).astype(BF))
    f = torch.from_numpy(feats).to(TBF).requires_grad_(True)
    got = W.windowed_scatter_mean(f, torch.from_numpy(idx), N, spec)
    got.backward(torch.from_numpy(g).to(TBF))
    assert got.dtype == TBF and want.dtype == BF and f.grad.dtype == TBF and want_g.dtype == BF
    assert in_ulps(got, want) <= 1.0
    assert in_ulps(f.grad, want_g) <= 1.0
    claimed = np.zeros((2, N), bool)
    for b in range(2):
        claimed[b, idx[b].ravel()] = True
    assert (got.detach().float().numpy()[~claimed] == 0).all()


@pytest.mark.parametrize("S,N,C", [(128, 256, 16), (64, 64, 32)])
def test_windowed_knn_widens_bf16_rows(S, N, C, interpret):
    """The windowed kNN of bf16 feature rows: float32 distances and the
    indices of the float32 search on the widened rows, which are those of
    ``mpa_tpu``'s Pallas kernel on the bf16 rows (it widens them)."""
    base, query = (bf16_np(a) for a in _sorted_pair(S + N + C, 2, S, N, C=C))
    jspec = JWA.make_window_spec(S, N, sq=32)
    want = np.asarray(JWA.windowed_knn_indices(8, jnp.asarray(base).astype(BF),
                                               jnp.asarray(query).astype(BF), jspec))
    b16, q16 = torch.from_numpy(base).to(TBF), torch.from_numpy(query).to(TBF)
    d16, i16, spec = W.windowed_knn_with_spec(8, b16, q16, sq=32)
    d32, i32, _ = W.windowed_knn_with_spec(8, b16.float(), q16.float(), sq=32)
    assert d16.dtype == torch.float32 and spec == W.make_window_spec(S, N, sq=32)
    assert torch.equal(i16, i32) and torch.equal(d16, d32)
    np.testing.assert_array_equal(i16.numpy(), want)


def test_windowed_scatter_mean_form_of_bf16_rows():
    """``windowed_scatter_mean_form`` gives bf16 rows eight channels a lane
    where eight divide the width and the rows start on 16 bytes, four where
    four do on 8, else one; float32 rows four or one."""
    def rows(width, offset, dtype=TBF):
        n = 2 * 300 * width
        return torch.zeros(n + offset, dtype=dtype)[offset:].view(2, 300, width)

    assert W.windowed_scatter_mean_form(rows(64, 0), 2048)[1] == 8
    assert W.windowed_scatter_mean_form(rows(12, 0), 2048)[1] == 4
    assert W.windowed_scatter_mean_form(rows(64, 4), 2048)[1] == 4
    assert W.windowed_scatter_mean_form(rows(64, 1), 2048)[1] == 1
    assert W.windowed_scatter_mean_form(rows(64, 0, torch.float32), 2048)[1] == 4
    assert W.windowed_scatter_mean_form(rows(7, 0, torch.float32), 2048)[1] == 1


# -- markov_partseg in the window modes, bf16, against mpa_tpu in bf16 -----------------


class _Pins:
    """The port's feature-space searches (exact ``knn`` and
    ``windowed_knn_with_spec`` of ``local_merge``) with their indices
    recorded in call order (``pins`` None) or replaced by the next pin."""

    def __init__(self, module, pins=None):
        self.module = module
        self.real = {"knn": module.knn, "windowed_knn_with_spec": module.windowed_knn_with_spec}
        self.record = pins is None
        self.pins = [] if pins is None else list(pins)

    def _wrap(self, name):
        real = self.real[name]

        def search(k, base, query, *rest):
            out = real(k, base, query, *rest)
            if not _feature_search(base):
                return out
            idx = out[1]
            if self.record:
                self.pins.append(idx.clone())
                return out
            pin = self.pins.pop(0)
            assert pin.shape == idx.shape, (pin.shape, idx.shape)
            return (out[0], pin) + tuple(out[2:])

        return search

    def __enter__(self):
        for name in self.real:
            setattr(self.module, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.module, name, fn)


def _tpu_contract(monkeypatch):
    """``mpa_tpu``'s windowed scatter-mean and windowed kNN as its TPU kernels
    compute them (module doc), here by monkeypatch."""
    import mpa_tpu.nn.window_mode as jax_window_mode

    def scatter_mean(f, i, n, *_spec, **_kw):
        return jax_scatter_mean(f.astype(jnp.float32), i, n).astype(f.dtype)

    real_knn = JWA.windowed_knn_with_spec

    def windowed_knn(k, base, query, sq=128):
        d, idx, spec = real_knn(k, base.astype(jnp.float32), query.astype(jnp.float32), sq=sq)
        return d.astype(jnp.promote_types(base.dtype, jnp.float32)), idx, spec

    monkeypatch.setattr(JWA, "windowed_scatter_mean", scatter_mean)
    monkeypatch.setattr(jax_window_mode, "scatter_mean_upsample", scatter_mean)
    monkeypatch.setattr(JWA, "windowed_knn_with_spec", windowed_knn)


# mode -> (variables, mpa_tpu's bf16 run compiled), shared by the seeds.
_COMPILED = {}
# (mode, seed) -> the readings of _window_model_runs, shared by the tests.
_RUNS = {}


def _window_model_runs(monkeypatch, mode, seed):
    """``_model_runs`` of ``tests/test_torch_port_bf16.py`` for
    ``markov_partseg`` in ``mode`` at ``NARROW``: the port in bf16 and in
    float32 and ``mpa_tpu`` in bf16 (its TPU contract, ``_tpu_contract``),
    eval log-probs and the train-mode gradients of ``sum(log-probs * w)``,
    dropout 0. Every feature-space search of ``mpa_tpu`` (exact in
    ``window``, windowed in ``window_all``) takes the neighbours the port's
    bf16 model found, and its own widened search's agreement with them is
    returned too. Returns ``(gaps, argmax agreement, neighbour
    agreement)``."""
    if (mode, seed) in _RUNS:
        return _RUNS[mode, seed]
    import mpa_tpu.nn.local_merge as jax_local_merge
    import mpa_tpu_torch.nn.local_merge as port_local_merge

    _tpu_contract(monkeypatch)
    cfg = dict(NARROW, neighbor_mode=mode, dropout=0.0)
    x, onehot = _seg_inputs(seed)
    jx, tx = (jnp.asarray(x), jnp.asarray(onehot)), (torch.from_numpy(x), torch.from_numpy(onehot))
    w = np.random.default_rng(seed + 2).standard_normal((2, 256, 50)).astype(np.float32)
    if mode not in _COMPILED:
        _COMPILED[mode] = (jax_variables_jit(JaxMarkovPartSeg(**cfg), [], (jx,), seed=0), None)
    flat, compiled = _COMPILED[mode]
    out = {}
    kernels.reset_launch_counts()
    for dt in (TBF, None):
        tm, unused = port(MarkovPartSeg(compute_dtype=dt, **cfg), flat)
        assert unused == []
        with _Pins(port_local_merge) as pinned:
            with torch.no_grad():
                lp = tm(tx)
            tm.train()
            (tm(tx) * torch.from_numpy(w)).sum().backward()
        pins = pinned.pins if dt else pins
        assert lp.dtype == torch.float32
        out["bf16" if dt else "f32"] = (
            lp.numpy(), {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                         for n, p in tm.named_parameters()})
    assert not any(kernels.LAUNCHES.values()) and not any(kernels.LAUNCHES_BF16.values())
    assert pins, "no feature-space search was pinned"
    jm = JaxMarkovPartSeg(compute_dtype=BF, **cfg)

    def run(params, batch_stats, x, w, pinned):
        left, agree = list(pinned), []
        real = {"knn": jax_local_merge.knn, "windowed": JWA.windowed_knn_with_spec}

        def pin_of(idx):
            pin = left.pop(0)
            assert pin.shape == idx.shape, (pin.shape, idx.shape)
            agree.append(jnp.mean((idx == pin).astype(jnp.float32)))
            return pin.astype(idx.dtype)

        def knn_pinned(k, base, query):
            dist, idx = real["knn"](k, base, query)
            return (dist, pin_of(idx)) if _feature_search(base) else (dist, idx)

        def windowed_pinned(k, base, query, sq=128):
            dist, idx, spec = real["windowed"](k, base, query, sq=sq)
            return (dist, pin_of(idx), spec) if _feature_search(base) else (dist, idx, spec)

        jax_local_merge.knn, JWA.windowed_knn_with_spec = knn_pinned, windowed_pinned
        try:
            lp_eval = jm.apply({"params": params, "batch_stats": batch_stats}, x, train=False)

            def loss(p):
                lp, _ = jm.apply({"params": p, "batch_stats": batch_stats}, x, train=True,
                                 mutable=["batch_stats"])
                return jnp.sum(lp * w)

            grads = jax.grad(loss)(params)
        finally:
            jax_local_merge.knn, JWA.windowed_knn_with_spec = real["knn"], real["windowed"]
        assert not left, f"{len(left)} pinned searches not made"
        return lp_eval, grads, jnp.stack(agree)

    v = _nest(flat)
    args = (v["params"], v["batch_stats"], jx, jnp.asarray(w),
            [jnp.asarray(p.numpy().astype(np.int32)) for p in pins])
    if compiled is None:
        compiled = jax.jit(run).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        _COMPILED[mode] = (flat, compiled)
    jlp, jgrads, agree = compiled(*args)
    flat_g = {"params/" + "/".join(p.key for p in path): np.asarray(leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    tm = MarkovPartSeg(**cfg)
    conv = {n: t.numpy() for n, t in from_jax_variables(flat_g, tm)[0].items()}
    jlp = np.asarray(jlp)
    argmax = float((out["bf16"][0].argmax(-1) == jlp.argmax(-1)).mean())
    _RUNS[mode, seed] = (_gaps(out, jlp, conv), argmax, np.asarray(agree))
    return _RUNS[mode, seed]


# The seeds of each mode. At NARROW every scale pair has two chunks, so a
# window spans its whole cloud and the windowed searches find the exact
# neighbours: the two modes differ here in which search runs (exact knn or
# windowed_knn_with_spec on the widened rows), not in its answer, and the
# windows proper are held by the op tests above and on the card. mpa_tpu's
# own feature searches agree with the port's neighbours on every row at
# these seeds but (mode, seed): NEAR_TIES, where a near tie of two bf16
# feature rows decides a neighbour (the two sides' bf16 features differ in
# a last bit here and there). Read: ("window", 8), one served search at
# 0.999 of its rows; ("window", 9) and ("window_all", 9), the train
# forward's four decoder searches at 0.904-0.986 (its train-mode
# BatchNorms over 32-512 rows carry a rounding to every row, as
# PARTSEG_GAP_SHARE says); every served search of the others at 1.
WINDOW_SEEDS = [7, 8, 9]
NEAR_TIES = {("window", 8), ("window", 9), ("window_all", 9)}
# The served searches' share of rows that a near tie may decide (read: at
# least 0.999).
SERVED_NEIGHBOUR_AGREEMENT = 0.99


@pytest.mark.parametrize("seed", WINDOW_SEEDS)
@pytest.mark.parametrize("mode", ["window", "window_all"])
def test_markov_partseg_bf16_window_modes_against_mpa_tpu(monkeypatch, mode, seed):
    """Served log-probs (argmax agreement 0.99 or more) and train-mode
    gradients within ``PARTSEG_GAP_SHARE`` of ``mpa_tpu``'s bf16 model."""
    gaps, argmax, agree = _window_model_runs(monkeypatch, mode, seed)
    assert argmax >= 0.99, argmax
    _hold_model(gaps, PARTSEG_GAP_SHARE)
    served = agree[:len(agree) // 2]  # the eval forward's searches, then the train forward's
    assert served.min() >= SERVED_NEIGHBOUR_AGREEMENT, agree
    assert ((mode, seed) in NEAR_TIES) == bool((agree < 1.0).any()), agree


@pytest.mark.parametrize("mode", ["window", "window_all"])
def test_markov_partseg_bf16_window_gradient_gap_over_the_seeds(monkeypatch, mode):
    """The whole gradient's gap pooled over ``WINDOW_SEEDS``."""
    gaps = [_window_model_runs(monkeypatch, mode, s)[0]["grads_l2"] for s in WINDOW_SEEDS]
    pooled = np.sqrt(sum(g ** 2 for g, _ in gaps)) / np.sqrt(sum(r ** 2 for _, r in gaps))
    assert pooled <= PARTSEG_GAP_SHARE["grads_l2_pooled"], pooled


# -- act: LinearUnit and PointNetFeaturePropagation --------------------------------------


@pytest.mark.parametrize("act", [False, True])
def test_linear_unit_act(act):
    """``LinearUnit(act=)`` against flax's ``act`` field, eval mode with
    randomised statistics: the LeakyReLU applied or not, within 1e-5."""
    x = _x(11, (2, 12, 6))
    jm = JaxLinearUnit(10, act=act)
    flat = jax_variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(_nest(flat), jnp.asarray(x), train=False))
    tm, unused = port(LinearUnit(6, 10, act=act), flat)
    assert unused == [] and tm.act is act
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert (want < 0).any()  # where the LeakyReLU acts
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("skip", [False, True])
def test_feature_propagation_act(act, skip):
    """``PointNetFeaturePropagation``'s default is ``mpa_tpu``'s,
    ``act=False``; both values against ``mpa_tpu`` within 1e-5, the same
    parameter names either way."""
    rng = np.random.default_rng(20 + act + 2 * skip)
    B, n, S, C, Cs, out = 2, 48, 16, 12, 5, 8
    fine = jnp.asarray(rng.standard_normal((B, n, 3)).astype(np.float32))
    coarse = jnp.asarray(rng.standard_normal((B, S, 3)).astype(np.float32))
    feats = jnp.asarray(rng.standard_normal((B, S, C)).astype(np.float32))
    sk = jnp.asarray(rng.standard_normal((B, n, Cs)).astype(np.float32)) if skip else None
    kw = {"act": True} if act else {}  # act=False: both defaults
    jm = JaxFeaturePropagation(out, **kw)
    flat = jax_variables(jm, fine, coarse, feats, sk)
    want = np.asarray(jm.apply(_nest(flat), fine, coarse, feats, sk, train=False))
    width = C + (Cs if skip else 0)
    tm = PointNetFeaturePropagation(width, out, **kw)
    assert tm.conv.act is act and (want < 0).any()
    assert [k for k, _ in tm.named_parameters()] == [
        k for k, _ in PointNetFeaturePropagation(width, out, act=not act).named_parameters()]
    tm, unused = port(tm, flat)
    assert unused == []
    t = [None if a is None else torch.from_numpy(np.array(a)) for a in (fine, coarse, feats, sk)]
    with torch.inference_mode():
        got = tm(*t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_markov_partseg_fp_propagation_acts():
    """``markov_partseg_fp`` builds every propagation with ``act=True``, as
    ``mpa_tpu/models/markov_partseg_fp.py:91-93`` does."""
    from mpa_tpu_torch.models import MarkovPartSegFP

    model = MarkovPartSegFP(npoints=(128, 64, 32, 16), channels=(16, 16, 16, 32, 32))
    ups = [m for m in model.modules() if isinstance(m, PointNetFeaturePropagation)]
    assert len(ups) == 4 and all(m.conv.act for m in ups)
