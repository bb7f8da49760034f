"""Port parity, inference export (``mpa_tpu_torch/serve/export.py``), on the CPU.

The counterpart of ``tests/test_serve.py``: a tiny ``markov_cls``
(``npoints=(16, 8)``, ``channels=(8, 8, 8)``, 2 x 32 points) whose
``mpa_tpu`` weights are carried across with ``utils/convert.py`` is
exported, saved and loaded, and held against ``mpa_tpu``'s live eval step
and against ``mpa_tpu.serve.load_inference`` of ``mpa_tpu``'s own artifact;
the manifest's fields; a wrong-shape input refused; a part-seg ladder
(``npoints=(32, 16, 8, 4)`` on 64 points) against ``mpa_tpu``'s exported
part-seg; a bf16 ``markov_cls`` bit-equal to the port's eager bf16 model;
and ``load_inference`` in a fresh ``python -c`` process that imports no
model code. On the CPU the program holds the plain ops; the card's program,
through the ``mpa::`` custom ops, is traced here with stand-in CPU kernels
(the plain versions registered for the ops): the cls, part-seg (exact and
``window_all``) and ``repsurf_ssg_2x`` graphs call each op as often as an
eager run does, nine forward ops between them, and give the eager answer
bit for bit. The card itself runs the exports in ``chip_smoke.py`` phase 9
and ``tests/test_torch_port_cuda.py``.

Tolerances: against ``mpa_tpu`` 1e-5 (XLA's CPU kernels sum in other
orders); against the port's own eager model bit-equal (the program runs
the same ops in the same order).
"""

import importlib
import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)
from test_torch_port_cls import _flat, port  # noqa: E402

from mpa_tpu import serve as jax_serve  # noqa: E402
from mpa_tpu import train as jax_train  # noqa: E402
from mpa_tpu.models import get_model as jax_get_model  # noqa: E402
from mpa_tpu_torch.models import get_model  # noqa: E402
from mpa_tpu_torch.ops import library  # noqa: E402
from mpa_tpu_torch.ops.window import WindowSpec  # noqa: E402
from mpa_tpu_torch.serve import (  # noqa: E402
    export_inference, load_exported, load_inference, save_exported,
)
from mpa_tpu_torch.serve.export import custom_ops  # noqa: E402
from mpa_tpu_torch.utils.init import init_like_flax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CLS = dict(npoints=(16, 8), channels=(8, 8, 8))
TINY_LADDER = (32, 16, 8, 4)


def _points(seed, B, N):
    return np.random.default_rng(seed).standard_normal((B, N, 3)).astype(np.float32)


def _jax_state(model, inputs):
    """``mpa_tpu``'s train state as ``tests/test_serve.py`` builds it."""
    tx = jax_train.make_optimizer("adam-l2", 1e-3, weight_decay=0.0)
    return jax_train.create_train_state(model, jax.random.key(1), inputs, tx)


def _variables(state):
    return _flat(jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                     "batch_stats": state.batch_stats}))


@pytest.fixture(scope="module")
def tiny_cls():
    """The tiny classifier on both sides: ``(jax model, jax state, port
    model, points)``."""
    pts = _points(0, 2, 32)
    jm = jax_get_model("markov_cls", num_classes=5, **TINY_CLS)
    state = _jax_state(jm, jnp.asarray(pts))
    tm, unused = port(get_model("markov_cls", num_classes=5, residuals=(True, False, False),
                                **TINY_CLS), _variables(state))
    assert unused == []
    return jm, state, tm, pts


def test_export_roundtrip_matches_mpa_tpu(tmp_path, tiny_cls):
    jm, state, tm, pts = tiny_cls
    live = np.asarray(jax.jit(jax_train.make_eval_step())(state, jnp.asarray(pts)))
    jax_path = str(tmp_path / "cls.shlo")
    jax_serve.save_exported(jax_serve.export_inference(jm, state.params, state.batch_stats,
                                                       jnp.asarray(pts)), jax_path)
    jax_art = np.asarray(jax_serve.load_inference(jax_path)(jnp.asarray(pts)))

    path = str(tmp_path / "cls.pt2")
    save_exported(export_inference(tm, torch.from_numpy(pts), device="cpu"), path,
                  manifest={"model": "markov_cls"})
    got = load_inference(path)(torch.from_numpy(pts))
    assert got.shape == (2, 5) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), live, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jax_art, rtol=0, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(got, tm(torch.from_numpy(pts)))


def test_manifest_fields(tmp_path, tiny_cls):
    *_, tm, pts = tiny_cls
    path = str(tmp_path / "cls.pt2")
    ep = export_inference(tm, torch.from_numpy(pts), device="cpu")
    save_exported(ep, path, manifest={"model": "markov_cls", "serve_batch": 2})
    man = json.load(open(path + ".json"))
    assert man["device"] == "cpu"
    assert man["in_avals"] == ["float32[2, 32, 3]"]
    assert man["out_avals"] == ["float32[2, 5]"]
    assert man["torch"] == torch.__version__
    assert man["op_namespace"] == library.NAMESPACE == "mpa"
    assert "mpa_tpu_torch.ops" in man["requires"]
    assert man["custom_ops"] == []  # the CPU program holds the plain ops
    assert man["graph_nodes"] == len(ep.graph.nodes) > 0
    assert man["model"] == "markov_cls" and man["serve_batch"] == 2
    assert os.path.getsize(path) > 1000 and not os.path.exists(path + ".tmp.pt2")
    assert isinstance(load_exported(path), torch.export.ExportedProgram)


def test_exported_rejects_wrong_shape(tmp_path, tiny_cls):
    *_, tm, pts = tiny_cls
    path = str(tmp_path / "cls.pt2")
    save_exported(export_inference(tm, torch.from_numpy(pts), device="cpu"), path)
    infer = load_inference(path)
    for bad in (torch.zeros((2, 64, 3)), torch.zeros((3, 32, 3)),
                torch.zeros((2, 32, 3), dtype=torch.float64)):  # N, batch, dtype
        with pytest.raises(ValueError, match=r"takes \['float32\[2, 32, 3\]'\]"):
            infer(bad)


def test_partseg_export_matches_mpa_tpu(tmp_path):
    pts = _points(1, 2, 64)
    onehot = np.eye(16, dtype=np.float32)[[0, 2]]
    jm = jax_get_model("markov_partseg", npoints=TINY_LADDER)
    state = _jax_state(jm, (jnp.asarray(pts), jnp.asarray(onehot)))
    jax_path = str(tmp_path / "seg.shlo")
    jax_serve.save_exported(jax_serve.export_inference(
        jm, state.params, state.batch_stats, (jnp.asarray(pts), jnp.asarray(onehot))), jax_path)
    want = np.asarray(jax_serve.load_inference(jax_path)((jnp.asarray(pts), jnp.asarray(onehot))))

    tm, unused = port(get_model("markov_partseg", npoints=TINY_LADDER), _variables(state))
    assert unused == []
    example = (torch.from_numpy(pts), torch.from_numpy(onehot))
    path = str(tmp_path / "seg.pt2")
    save_exported(export_inference(tm, example, device="cpu"), path)
    got = load_inference(path)(example)
    assert got.shape == (2, 64, 50)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(got, tm(example))


def test_bf16_cls_export_is_bit_equal_to_eager(tmp_path):
    tm = get_model("markov_cls", num_classes=5, residuals=(True, False, False),
                   compute_dtype=torch.bfloat16, **TINY_CLS)
    init_like_flax(tm, torch.Generator().manual_seed(3))
    x = torch.from_numpy(_points(2, 2, 32))
    path = str(tmp_path / "cls_bf16.pt2")
    save_exported(export_inference(tm, x, device="cpu"), path)
    got = load_inference(path)(x)
    with torch.no_grad():
        want = tm.eval()(x)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_load_inference_in_a_fresh_process(tmp_path, tiny_cls):
    *_, tm, pts = tiny_cls
    path = str(tmp_path / "cls.pt2")
    save_exported(export_inference(tm, torch.from_numpy(pts), device="cpu"), path)
    np.save(tmp_path / "x.npy", pts)
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]); import numpy as np, torch; "
        "torch.set_num_threads(1); "
        "from mpa_tpu_torch.serve import load_inference; "
        "out = load_inference(sys.argv[2])(np.load(sys.argv[3])); "
        "assert 'mpa_tpu_torch.models' not in sys.modules; "
        "np.save(sys.argv[4], out.numpy())"
    )
    subprocess.run([sys.executable, "-c", code, REPO, path, str(tmp_path / "x.npy"),
                    str(tmp_path / "out.npy")], check=True, timeout=300,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    with torch.no_grad():
        want = tm(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


# -- the card's program, traced on the CPU with stand-in kernels -----------------

OP_MODULES = ("knn", "fps", "gather", "attention", "scatter", "window", "ball_query")


def _stand_ins():
    """A CPU kernel for each ``mpa::`` op: its plain version."""
    m = {name: importlib.import_module(f"mpa_tpu_torch.ops.{name}") for name in OP_MODULES}
    att, sc = m["attention"], m["scatter"]

    def spec(query, base, sq, bn, n_chunks):
        return WindowSpec(S=query.shape[1], N=base.shape[1], sq=sq, bn=bn, n_chunks=n_chunks)

    return {
        "knn": m["knn"].knn_plain,
        "fps": lambda p, n, start, starts: m["fps"].fps_plain(p, n, start if starts is None
                                                             else starts),
        "gather": m["gather"].gather_plain,
        "scatter_add": m["gather"].scatter_add_plain,
        "attention": att.attention_plain,
        "attention_bwd": att.attention_bwd_plain,
        "scatter_mean": sc.scatter_mean_plain,
        "windowed_knn": lambda k, b, q, *sp: m["window"].windowed_knn_plain(
            k, b, q, spec(q, b, *sp)),
        "windowed_attention": lambda p, i, s, nb, c, *sp: att.attention_plain(p, i, s, nb, c),
        "windowed_attention_bwd": lambda p, i, s, g, nb, c, *sp: att.attention_bwd_plain(
            p, i, s, g, nb, c),
        "windowed_scatter_mean": lambda f, i, n, *sp: sc.scatter_mean_plain(f, i, n),
        "ball_query": m["ball_query"].ball_query_plain,
    }


@pytest.fixture
def stand_in_kernels(monkeypatch):
    """The ops' CUDA path on CPU tensors: every wrapper takes its op
    (``on_cuda`` true, the ops' checks taking the CPU device) and each op
    runs its stand-in, counted; yields the counts. The registrations are
    removed at the end."""
    calls = Counter()
    lib = torch.library.Library(library.NAMESPACE, "IMPL")
    for name, fn in _stand_ins().items():
        def kernel(*args, _name=name, _fn=fn):
            calls[_name] += 1
            return _fn(*args)
        lib.impl(name, kernel, "CPU")
    monkeypatch.setattr(library, "kernel_device", lambda t: True)
    for name in OP_MODULES:
        monkeypatch.setattr(importlib.import_module(f"mpa_tpu_torch.ops.{name}"), "on_cuda",
                            lambda t, name=None: True)
    yield calls
    lib._destroy()


STAND_IN_CASES = {
    "cls": ({"knn", "fps", "gather", "attention"},),
    "partseg": ({"knn", "fps", "gather", "attention", "scatter_mean"},),
    "partseg_window_all": ({"windowed_knn", "fps", "gather", "windowed_attention",
                            "windowed_scatter_mean"},),
    "repsurf": ({"knn", "fps", "gather", "ball_query"},),
}


def _stand_in_model(path):
    from mpa_tpu_torch.data import surface_clouds

    if path == "cls":
        model = get_model("markov_cls", num_classes=5, residuals=(True, False, False), **TINY_CLS)
        example = torch.from_numpy(_points(4, 2, 32))
    elif path == "repsurf":  # its set abstractions sample 512 centres: full width
        model = get_model("repsurf_ssg_2x", num_classes=15)
        example = torch.from_numpy(surface_clouds(1, 1024, seed=0)[0])
    else:
        n = 64 if path == "partseg" else 256
        model = get_model("markov_partseg", npoints=tuple(n // 2 ** (i + 1) for i in range(4)),
                          neighbor_mode="exact" if path == "partseg" else "window_all")
        example = (torch.from_numpy(_points(5, 2, n)),
                   torch.from_numpy(np.eye(16, dtype=np.float32)[[0, 2]]))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return model.eval(), example


@pytest.mark.parametrize("path", sorted(STAND_IN_CASES))
def test_card_path_exports_through_the_ops(tmp_path, stand_in_kernels, path):
    (ops,) = STAND_IN_CASES[path]
    model, example = _stand_in_model(path)
    with torch.no_grad():
        want = model(example)
    eager = dict(stand_in_kernels)
    stand_in_kernels.clear()
    ep = export_inference(model, example, device="cpu")
    assert not stand_in_kernels  # the trace ran the fakes alone
    in_graph = Counter(n.target.name().split("::")[1] for n in ep.graph.nodes
                       if n.op == "call_function" and n.target in
                       {getattr(torch.ops.mpa, o).default for o in library.OPS})
    assert set(in_graph) == ops and dict(in_graph) == eager
    assert custom_ops(ep) == sorted(f"mpa::{o}" for o in ops)
    save_exported(ep, str(tmp_path / "m.pt2"))
    got = load_inference(str(tmp_path / "m.pt2"))(example)
    assert dict(stand_in_kernels) == eager
    assert torch.equal(got, want)


def test_stand_in_paths_cover_the_nine_forward_ops():
    """The stand-in paths reach every op but the backward ones and the
    train-mode BatchNorm's pair, which an eval-mode program never calls."""
    forward = set().union(*(ops for (ops,) in STAND_IN_CASES.values()))
    assert len(forward) == 9 and forward == set(library.OPS) - {
        "scatter_add", "attention_bwd", "windowed_attention_bwd", "batch_norm_act",
        "batch_norm_act_bwd"}
