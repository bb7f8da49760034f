"""Port parity, data parallelism, on the CPU.

Two ranks (spawned processes, the ``gloo`` backend, a ``file://``
rendezvous under ``tmp_path``) each take half of a global batch through
``parallel.make_data_parallel_train_step`` with cross-replica BatchNorm;
one process takes the whole batch through the plain step. Classification
at narrow widths takes two steps, part segmentation (its scatter-mean
decoder) one. The losses, every parameter and the BatchNorm running mean
and biased variance agree within 1e-5 of each tensor's largest entry, and
within 1e-7 (a float32 rounding of a unit entry) where that is less: the
biases that start at zero hold one or two steps' updates, and the ``k``
biases, whose shift cancels in the attention's normalisation, hold rounding
alone. The two ranks hold bit-equal states. The one-process classification run is
also held against ``mpa_tpu``'s sharded train step on its 8-device virtual
CPU mesh (``tests/conftest.py``), from the same weights carried across, so
the global-batch semantics are ``mpa_tpu``'s.

Both runs use SGD and dropout 0: ranks draw their own dropout masks, and
Adam turns a gradient that is zero up to rounding into a full step of
either sign (``test_torch_port_train.py::test_adam_steps_match_mpa_tpu``),
which would hide what is compared here. In float64 that rounding is far
below Adam's epsilon, so one case runs the cls preset itself (adam-l2) in
float64, held within 1e-8: the two-rank step is the one-process step, and
what float32 leaves between them is rounding (at full width and eight
clouds, float32's near-tie selections amplify it to whole per-cent of a
second step's gradients, which float64 reads at 1e-15). Part segmentation runs its recipe
at a tenth of its learning rate: at 0.1 one entry of ``la0``'s ``conv_res``
weight read 1.03e-5 of its tensor's scale, the rounding of the two
BatchNorm reductions amplified by the train-mode gradient's conditioning
at eight clouds (``test_torch_port_train.py``'s Adam steps describe it),
and the step scales that with the rate. The spawned processes import no
JAX; every join has a timeout.
"""

import multiprocessing as mp
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mpa_tpu_torch import parallel  # noqa: E402
from mpa_tpu_torch.configs import PRESETS  # noqa: E402
from mpa_tpu_torch.data.pipeline import global_batch_from_local  # noqa: E402
from mpa_tpu_torch.data.shapenetpart import to_categorical  # noqa: E402
from mpa_tpu_torch.models import MarkovClassifier, MarkovPartSeg  # noqa: E402
from mpa_tpu_torch.nn.linear import BatchNorm  # noqa: E402
from mpa_tpu_torch.train import TRAIN_STEPS, create_train_state  # noqa: E402
from mpa_tpu_torch.utils.init import init_like_flax  # noqa: E402

# The suite's workers share the cores: one torch thread a process (as
# tests/test_torch_port_cls.py pins it; that module imports JAX, which the
# spawned ranks do not need).
torch.set_num_threads(1)

CPU = torch.device("cpu")
CLS_SMALL = dict(npoints=(64, 32, 16, 8, 4), channels=(16, 16, 16, 32, 32, 64),
                 encoder_features=64)  # test_torch_port_cls.SMALL
PARTSEG_NARROW = dict(npoints=(128, 64, 32, 16), channels=(16, 16, 16, 32, 32))
B, SPE, RANKS = 8, 4, 2
CASES = {
    # the cls preset's rate, with SGD in place of Adam (module doc)
    "cls": dict(points=128, steps=2, cfg=PRESETS["scanobjectnn_cls"].with_overrides(
        optimizer="sgd")),
    # the part-seg recipe at a tenth of its rate (module doc)
    "partseg": dict(points=256, steps=1, cfg=PRESETS["shapenetpart"].with_overrides(
        learning_rate=0.01)),
    # the cls preset (adam-l2) in float64
    "cls_f64": dict(points=128, steps=2, cfg=PRESETS["scanobjectnn_cls"], dtype=torch.float64),
}


def _model(case: str):
    if case.startswith("cls"):
        model = MarkovClassifier(num_classes=15, dropout=0.0, **CLS_SMALL)
    else:
        model = MarkovPartSeg(dropout=0.0, **PARTSEG_NARROW)
    return model.to(CASES[case].get("dtype", torch.float32))


def _batches(case: str):
    """The case's global host batches: ``(inputs, labels)`` numpy arrays,
    part-seg's inputs the pair (points, one-hot)."""
    spec = CASES[case]
    out = []
    for i in range(spec["steps"]):
        rng = np.random.default_rng(40 + i)
        pts = rng.standard_normal((B, spec["points"], 3)).astype(np.float32)
        if case.startswith("cls"):
            out.append((pts, rng.integers(0, 15, B)))
        else:
            cats = rng.integers(0, 16, B)
            out.append(((pts, to_categorical(cats, 16)), rng.integers(0, 50, (B, spec["points"]))))
    return out


def _tensors(inputs, labels, rank=0, ranks=1):
    """This rank's rows of a global batch, as tensors (``parallel.shard_batch``)."""
    if isinstance(inputs, tuple):
        pts, onehot, y = parallel.shard_batch((inputs[0], inputs[1], labels), CPU, rank, ranks)
        return (pts, onehot), y
    return parallel.shard_batch((inputs, labels), CPU, rank, ranks)


def _run(case: str, weights: str, rank: int = 0, ranks: int = 1):
    """Train the case from ``weights`` (a saved state dict): the plain step
    in one process, the data-parallel step when a group is joined. Returns
    the losses and the state dict after each step."""
    cfg = CASES[case]["cfg"]
    model = _model(case)
    model.load_state_dict(torch.load(weights, weights_only=True))
    state = create_train_state(model, cfg, CPU)
    if ranks > 1:
        parallel.replicate(parallel.sync_batchnorm(state.model))
        step = parallel.make_data_parallel_train_step(cfg, SPE)
    else:
        step = TRAIN_STEPS[cfg.task](cfg, SPE)
    losses, states = [], []
    dtype = CASES[case].get("dtype", torch.float32)
    for inputs, labels in _batches(case):
        x, y = _tensors(inputs, labels, rank, ranks)
        if ranks > 1:  # the ranks' shares gather back into the global batch
            assert torch.equal(global_batch_from_local(y), torch.from_numpy(labels))
        x = tuple(t.to(dtype) for t in x) if isinstance(x, tuple) else x.to(dtype)
        losses.append(float(step(state, x, y)))
        states.append({k: v.clone() for k, v in state.model.state_dict().items()})
    return losses, states


def _rank_main(rank: int, init_file: str, case: str, weights: str, out: str) -> None:
    torch.set_num_threads(1)
    parallel.init("gloo", device=CPU, init_method=f"file://{init_file}", rank=rank,
                  world_size=RANKS, timeout_s=120)
    try:
        torch.save(_run(case, weights, rank, RANKS), out)
    finally:
        dist.destroy_process_group()


def _two_ranks(case: str, weights: str, tmp_path):
    ctx = mp.get_context("spawn")
    outs = [str(tmp_path / f"{case}_rank{r}.pt") for r in range(RANKS)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp_path / f"{case}_rendezvous"), case, weights, outs[r]))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    assert not alive, "a rank hung"
    assert [p.exitcode for p in procs] == [0] * RANKS
    return [torch.load(o, weights_only=False) for o in outs]


def _assert_states_close(got: dict, want: dict, rel: float, what: str) -> None:
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        scale = max(float(w.abs().max()), 0.1)
        err = float((got[name] - w).abs().max())
        assert err <= rel * scale, f"{what}: {name} off by {err:.3e} (scale {scale:.3e})"


def _initial_weights(case: str, path) -> str:
    model = init_like_flax(_model(case), torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("case", ["cls", "partseg", "cls_f64"])
def test_two_gloo_ranks_match_one_process(case, tmp_path):
    rel = 1e-8 if case == "cls_f64" else 1e-5
    weights = _initial_weights(case, tmp_path / "init.pt")
    want_losses, want_states = _run(case, weights)
    (l0, s0), (l1, s1) = _two_ranks(case, weights, tmp_path)
    assert l0 == l1  # the step reports the global batch's loss on every rank
    np.testing.assert_allclose(l0, want_losses, rtol=rel, atol=0)
    for step, (a, b, w) in enumerate(zip(s0, s1, want_states)):
        for name in w:
            assert torch.equal(a[name], b[name]), f"ranks differ at {name} after step {step}"
        _assert_states_close(a, w, rel, f"step {step}")
    # The biased variance: against the one process's, which flax keeps.
    bn = [k for k in want_states[-1] if k.endswith("running_var")]
    assert bn and all(torch.allclose(s0[-1][k], want_states[-1][k], rtol=rel, atol=rel / 100)
                      for k in bn)


def test_batchnorm_without_a_group_is_unchanged():
    """No process group: the module's train mode is the one-process
    BatchNorm (``sync_batchnorm(model, False)`` takes a group away)."""
    model = _model("cls")
    assert all(m.process_group is None for m in model.modules() if isinstance(m, BatchNorm))
    x = torch.randn(4, 8, 16)
    bn = BatchNorm(16)
    bn.process_group = dist.group.WORLD if dist.is_initialized() else None
    parallel.sync_batchnorm(bn, False)
    assert bn.process_group is None
    y = bn.train()(x)
    mean = x.mean(dim=(0, 1))
    var = ((x - mean) ** 2).mean(dim=(0, 1))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(y, (x - mean) * torch.rsqrt(var + 1e-5), rtol=1e-5, atol=1e-5)


def test_one_process_matches_mpa_tpu_sharded_step(tmp_path):
    """Two SGD steps of the narrow classifier at global batch 8: the port in
    one process against ``mpa_tpu``'s ``jit_sharded_train_step`` over its 8
    virtual CPU devices (one cloud each, BatchNorm over all 8), from the
    same weights (``jax_variables``' randomised BatchNorm statistics
    included). The loss within 1e-5 and every entry within 1e-5 of its
    tensor's scale, as against the two ranks (read: 7.2e-7 and 1.5e-6). At
    the learning rate 0.05 the second step read 1.7e-2: train-mode
    BatchNorm and the near-tie selections amplify the first step's rounding,
    as ``test_torch_port_partseg_train``'s SGD steps describe."""
    import jax
    import jax.numpy as jnp

    from mpa_tpu import train as jtr
    from mpa_tpu.models import MarkovClassifier as JaxMarkovClassifier
    from mpa_tpu.parallel import jit_sharded_train_step, make_mesh, replicate, shard_batch
    from test_torch_port_cls import _nest, jax_variables, port
    from test_torch_port_train import _jax_state_to_port

    assert jax.device_count() == 8
    cfg = CASES["cls"]["cfg"]
    batches = _batches("cls")
    jm = JaxMarkovClassifier(num_classes=15, dropout=0.0, **CLS_SMALL)
    flat = jax_variables(jm, jnp.asarray(batches[0][0]))
    nested = _nest(flat)
    model, _ = port(_model("cls"), flat)
    weights = str(tmp_path / "carried.pt")
    torch.save(model.state_dict(), weights)
    losses, states = _run("cls", weights)

    sched = jtr.step_decay_schedule(cfg.learning_rate, cfg.decay_step, cfg.decay_gamma)
    tx = jtr.make_optimizer("sgd", lambda s: sched(s // SPE), cfg.weight_decay, cfg.momentum)
    mesh = make_mesh()
    jstate = replicate(jtr.TrainState.create(apply_fn=jm.apply, params=nested["params"], tx=tx,
                                             batch_stats=nested["batch_stats"]), mesh)
    jstep = jit_sharded_train_step(
        jtr.make_train_step(lambda out, y: jtr.smooth_cls_loss(out, y, cfg.label_smoothing)),
        mesh)
    key = replicate(jax.random.key(0), mesh)
    for (x, y), loss, got in zip(batches, losses, states):
        jstate, jloss = jstep(jstate, *shard_batch((x, y.astype(np.int32)), mesh), key)
        assert abs(loss - float(jloss)) <= 1e-5
        _assert_states_close(got, _jax_state_to_port(jstate, model), 1e-5, "against mpa_tpu")
