"""The fused train-mode BatchNorm + LeakyReLU (``mpa_tpu_torch/ops/batch_norm.py``)
on the CPU, where it takes its plain version.

Covered: the plain path gives the arithmetic the port ran before the fused
op (written out here as it stood) bit for bit, in the output, the running
statistics and every gradient, with and without the activation, through
``BatchNorm`` and ``LinearUnit``; the closed-form backward the kernels
compute against autograd of the plain forward in float64; which path each
mode takes (train mode without a process group reaches the fused op and
counts ``batch_norm_act.fused``; eval mode, a process group and CPU tensors
keep the plain code and count nothing), with the fused op's entry stood in
for by its plain version; the count a train-mode forward of ``markov_partseg``
and ``dgcnn`` makes; the reduction shape the kernels take from PyTorch's at
the main paths' shapes and that it reaches every value once; and the ops'
fakes. The kernels themselves run on the card, bit for bit against the plain
version (``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase 3b).
Imports no JAX.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpa_tpu_torch import kernels
from mpa_tpu_torch.configs import PRESETS, model_kwargs
from mpa_tpu_torch.models import get_model
from mpa_tpu_torch.nn.linear import BatchNorm, LinearUnit
from mpa_tpu_torch.ops import batch_norm as bn
from mpa_tpu_torch.utils import profiling

torch.set_num_threads(1)

EPS, MOMENTUM = 1e-5, 0.1


def _rand(seed, shape, dtype=torch.float32, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape) * scale + shift).to(dtype)


def _before(norm: BatchNorm, x: torch.Tensor, act: bool) -> torch.Tensor:
    """``BatchNorm.forward``'s train mode without a process group, and the
    unit's LeakyReLU after it, as the port ran them before the fused op."""
    dims = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=dims)
    centred = x - mean
    var = torch.mean(centred * centred, dim=dims)
    y = centred * (torch.rsqrt(var + norm.eps) * norm.weight) + norm.bias
    keep = 1.0 - norm.momentum
    with torch.no_grad():
        norm.running_mean.copy_(keep * norm.running_mean + (1.0 - keep) * mean)
        norm.running_var.copy_(keep * norm.running_var + (1.0 - keep) * var)
    return F.leaky_relu(y, negative_slope=0.2) if act else y


def _unit_pair(C_in: int, C: int, act: bool):
    torch.manual_seed(C_in * 100 + C)
    unit = LinearUnit(C_in, C, act=act)
    with torch.no_grad():
        unit.norm.weight.copy_(_rand(1, (C,), scale=0.3, shift=1.0))
        unit.norm.bias.copy_(_rand(2, (C,), scale=0.3))
        unit.norm.running_mean.copy_(_rand(3, (C,)))
        unit.norm.running_var.copy_(_rand(4, (C,)).abs())
    twin = LinearUnit(C_in, C, act=act)
    twin.load_state_dict(unit.state_dict())
    return unit.train(), twin.train()


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", [(2, 33, 5), (4, 16, 4, 7), (1, 1, 5)])
def test_plain_path_is_the_arithmetic_before_the_fused_op(shape, act):
    """``LinearUnit`` in train mode on the CPU: output, running statistics
    and the gradients of its input and of every parameter bit for bit those
    of the arithmetic written out in ``_before``."""
    C = 24
    unit, twin = _unit_pair(shape[-1], C, act)
    x = _rand(5, shape, shift=0.5).requires_grad_(True)
    x2 = x.detach().clone().requires_grad_(True)
    g = _rand(6, shape[:-1] + (C,))
    y = unit(x)
    want = _before(twin.norm, twin.linear(x2), act)
    assert torch.equal(y, want)
    (y * g).sum().backward()
    (want * g).sum().backward()
    assert torch.equal(x.grad, x2.grad)
    for (name, p), q in zip(unit.named_parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(unit.norm, name), getattr(twin.norm, name)), name
    assert profiling.COUNTS["batch_norm_act.fused"] == 0


@pytest.mark.parametrize("act", [True, False])
def test_batch_norm_act_plain_is_batch_norm_then_leaky_relu(act):
    """``BatchNorm(x, act)`` and ``batch_norm_act`` on CPU tensors give
    ``_before`` bit for bit, the running statistics too."""
    norm, twin = BatchNorm(6).train(), BatchNorm(6).train()
    x = _rand(7, (3, 10, 6), scale=2.0, shift=-1.0)
    want = _before(twin, x, act)
    assert torch.equal(norm(x, act=act), want)
    assert torch.equal(norm.running_mean, twin.running_mean)
    assert torch.equal(norm.running_var, twin.running_var)
    rm, rv = torch.zeros(6), torch.ones(6)
    got = bn.batch_norm_act(x, norm.weight, norm.bias, rm, rv, EPS, MOMENTUM, act)
    again = BatchNorm(6).train()
    assert torch.equal(got, _before(again, x, act))
    assert torch.equal(rm, again.running_mean) and torch.equal(rv, again.running_var)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("C", [3, 64, 1024])
@pytest.mark.parametrize("R", [1, 2, 7, 130])
def test_closed_form_backward_matches_autograd_in_float64(R, C, act):
    """``batch_norm_act_bwd_plain`` (the kernels' backward) at the forward's
    mean and rstd against autograd of ``batch_norm_act_plain``, float64."""
    if R * C > 70000:
        R = 70000 // C  # keeps the widest case small
    x = _rand(R * 10 + C, (R, C), torch.float64, scale=2.0, shift=0.3).requires_grad_(True)
    w = _rand(11, (C,), torch.float64, scale=0.5, shift=1.0).requires_grad_(True)
    b = _rand(12, (C,), torch.float64, scale=0.5).requires_grad_(True)
    dy = _rand(13, (R, C), torch.float64)
    y = bn.batch_norm_act_plain(x, w, b, torch.zeros(C, dtype=torch.float64),
                                torch.ones(C, dtype=torch.float64), EPS, MOMENTUM, act)
    want = torch.autograd.grad(y, (x, w, b), dy)
    with torch.no_grad():
        mean = x.mean(dim=0)
        rstd = torch.rsqrt(((x - mean) ** 2).mean(dim=0) + EPS)
        got = bn.batch_norm_act_bwd_plain(dy, x, w, b, mean, rstd, act)
    for name, g, ref in zip(("dx", "dweight", "dbias"), got, want):
        torch.testing.assert_close(g, ref, rtol=1e-9, atol=1e-9 * float(ref.abs().max()) + 1e-12,
                                   msg=lambda m: f"{name}: {m}")


def _fused_stand_in(monkeypatch):
    """Let the dispatcher take CPU tensors for card tensors, with the fused
    op's two entries (no grad, and the autograd function) run by the plain
    version; returns the list of the ``act`` flags the fused path saw."""
    seen = []

    def op(x, weight, bias, running_mean, running_var, eps, momentum, act):
        seen.append(act)
        y = bn.batch_norm_act_plain(x, weight, bias, running_mean, running_var, eps, momentum,
                                    act)
        return y, None, None

    def apply(x, weight, bias, running_mean, running_var, eps, momentum, act):
        return op(x, weight, bias, running_mean, running_var, eps, momentum, act)[0]

    monkeypatch.setattr(bn, "on_cuda", lambda t, name=None: True)
    monkeypatch.setattr(bn, "batch_norm_act_cuda", op)
    monkeypatch.setattr(bn._BatchNormAct, "apply", staticmethod(apply))
    return seen


@pytest.mark.parametrize("act", [True, False])
def test_train_mode_takes_the_fused_op_and_counts_it(monkeypatch, act):
    seen = _fused_stand_in(monkeypatch)
    unit, _ = _unit_pair(5, 8, act)
    profiling.reset_counts()
    unit(_rand(1, (2, 9, 5)))
    assert seen == [act] and profiling.COUNTS["batch_norm_act.fused"] == 1
    with torch.no_grad():
        unit(_rand(2, (2, 9, 5)))
    assert seen == [act, act] and profiling.COUNTS["batch_norm_act.fused"] == 2


@pytest.mark.parametrize("mode", ["eval", "process_group", "cpu"])
def test_other_modes_keep_the_plain_code_and_count_nothing(monkeypatch, mode):
    """Eval mode (``F.batch_norm``, then the LeakyReLU), a set process group
    (its all-reduced statistics; the sum over one rank stood in by the
    identity) and CPU tensors: the fused op is not reached, the counter
    stays 0, and the output is the plain code's."""
    unit, twin = _unit_pair(5, 8, True)
    x = _rand(3, (2, 9, 5))
    if mode == "eval":
        unit.eval(), twin.eval()
        z = twin.linear(x)
        flat = F.batch_norm(z.reshape(-1, 8), twin.norm.running_mean, twin.norm.running_var,
                            twin.norm.weight, twin.norm.bias, False, 0.0, EPS)
        want = F.leaky_relu(flat.reshape(z.shape), 0.2)
    else:
        want = _before(twin.norm, twin.linear(x), True)
    if mode == "process_group":
        unit.norm.process_group = object()
        monkeypatch.setattr(BatchNorm, "_global_sum", lambda self, t: t)
    seen = _fused_stand_in(monkeypatch) if mode != "cpu" else []
    profiling.reset_counts()
    y = unit(x)
    assert seen == [] and profiling.COUNTS["batch_norm_act.fused"] == 0
    if mode == "process_group":  # sum / count for the mean: the same to rounding
        torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(y, want)


def test_eval_without_grad_overwrites_the_norms_output_with_the_same_values():
    """Served (inference mode), the eval path applies the LeakyReLU in place
    on the norm's own output: the values are the out-of-place ones, bit for
    bit, and the unit's input is left as it was."""
    unit, _ = _unit_pair(5, 8, True)
    unit.eval()
    x = _rand(8, (2, 9, 5))
    want = unit(x).detach()
    with torch.inference_mode():
        z = unit.linear(x)
        z_before = z.clone()
        got = unit.norm(z, act=True)
    assert torch.equal(got, want) and torch.equal(z, z_before)


@pytest.mark.parametrize("preset,model,norms", [("shapenetpart", None, 81),
                                                ("scanobjectnn_cls", "dgcnn", 7)])
def test_a_train_forward_counts_every_norm_once(monkeypatch, preset, model, norms):
    """One train-mode forward of ``markov_partseg`` and of ``dgcnn`` counts
    ``batch_norm_act.fused`` once for each of its BatchNorms (81 and 7); an
    eval forward counts none."""
    B, N = 2, 256
    cfg = PRESETS[preset].with_overrides(num_points=N, **({"model": model} if model else {}))
    torch.manual_seed(0)
    net = get_model(cfg.model, **dict(model_kwargs(cfg), dropout=0.0))
    assert sum(isinstance(m, BatchNorm) for m in net.modules()) == norms
    _fused_stand_in(monkeypatch)
    points = _rand(4, (B, N, 3))
    if model is None:
        label = F.one_hot(torch.arange(B) % cfg.num_categories, cfg.num_categories).float()
        args = ((points, label),)
    else:
        args = (points,)
    profiling.reset_counts()
    with torch.no_grad():
        net.train()(*args)
        assert profiling.COUNTS["batch_norm_act.fused"] == norms
        net.eval()(*args)
    assert profiling.COUNTS["batch_norm_act.fused"] == norms


# The rows the benchmark's train cells normalise: part-seg at 256 x 2048
# points (C = 64 at full resolution, 512 in its head) and DGCNN at 64 x 1024
# (the edge rows x 20 at C = 64, 64, 128, 256; bn5 over the points at 1024;
# bn6 and bn7 over the clouds), and small and odd shapes.
SHAPES = [(524288, 64), (524288, 512), (1310720, 64), (1310720, 128), (1310720, 256),
          (65536, 1024), (64, 512), (64, 256), (1, 64), (7, 3), (1000, 10), (4096, 1030),
          (3, 2052), (16384, 13), (300, 6), (100, 12)]


@pytest.mark.parametrize("R,C", SHAPES)
def test_reduce_config_is_pytorchs_and_covers_every_value_once(R, C):
    """``reduce_config`` keeps PyTorch's limits (``Reduce.cuh``: at most 512 /
    vec threads a block, power-of-two row groups, a column split over blocks
    only where the row groups split the rows, enough blocks then to fill the
    card), and its threads, laid out as the kernels lay them, reach every
    (row, channel) of ``[R, C]`` once."""
    vec, bw, bh, ctas, out_mult_y, in_mult_y, step_output, step_input = bn.reduce_config(R, C)
    assert C % vec == 0 and vec == next(v for v in (4, 2, 1) if C % v == 0)
    assert bw * bh <= bn.MAX_THREADS // vec and bh & (bh - 1) == 0
    if in_mult_y:
        assert out_mult_y == 0 and step_output == bw and step_input == bh * ctas
    else:
        assert ctas == 1 and out_mult_y == bw and step_output == bw * bh and step_input == 1
    grid_x = -(-(C // vec) // step_output)
    if ctas > 1:
        target = bn.H100_SMS * (bn.H100_THREADS_PER_SM // (bw * bh))
        assert grid_x * ctas >= min(target, -(-R // (bh * 256)) * grid_x)
    if R * C > 200000:
        return  # the layout below, at the small shapes
    seen = np.zeros((R, C), dtype=np.int64)
    in_mult_cta = bh if ctas > 1 else 0
    for c1 in range(grid_x):
        for c2 in range(ctas):
            for y in range(bh):
                for x in range(bw):
                    ch = (x + y * out_mult_y + c1 * step_output) * vec
                    row = y * in_mult_y + c2 * in_mult_cta
                    if ch < C:
                        seen[row::step_input, ch:ch + vec] += 1
    assert (seen == 1).all()


def test_reduce_config_of_the_main_paths():
    """PyTorch's shapes at part-seg's and DGCNN's widest rows on an H100,
    worked out by hand from ``Reduce.cuh``: 16 x 8 or 32 x 4 threads of four
    channels, 2112 or 528 or 1280 blocks a column."""
    assert bn.reduce_config(524288, 64) == (4, 16, 8, 2112, 0, 1, 16, 8 * 2112)
    assert bn.reduce_config(524288, 512) == (4, 32, 4, 528, 0, 1, 32, 4 * 528)
    assert bn.reduce_config(1310720, 256) == (4, 32, 4, 1280, 0, 1, 32, 4 * 1280)
    assert bn.reduce_config(64, 512) == (4, 32, 4, 1, 0, 1, 32, 4)
    assert bn.reduce_config(1, 64) == (4, 16, 1, 1, 16, 0, 16, 1)


def test_fakes_give_shapes_and_refuse_what_the_kernels_refuse():
    R, C = 10, 12
    meta = {n: torch.empty(s, device="meta") for n, s in
            (("x", (R, C)), ("w", (C,)), ("b", (C,)), ("rm", (C,)), ("rv", (C,)))}
    y, mean, rstd = torch.ops.mpa.batch_norm_act.default(
        meta["x"], meta["w"], meta["b"], meta["rm"], meta["rv"], EPS, MOMENTUM, True)
    assert [(tuple(t.shape), t.dtype) for t in (y, mean, rstd)] == [
        ((R, C), torch.float32), ((C,), torch.float32), ((C,), torch.float32)]
    dx, dw, db = torch.ops.mpa.batch_norm_act_bwd.default(
        meta["x"], meta["x"], meta["w"], meta["b"], mean, rstd, False)
    assert [(tuple(t.shape), t.dtype) for t in (dx, dw, db)] == [
        ((R, C), torch.float32), ((C,), torch.float32), ((C,), torch.float32)]
    assert y.stride() == dx.stride() == (C, 1)
    with pytest.raises(ValueError, match="float32"):
        torch.ops.mpa.batch_norm_act.default(meta["x"].double(), meta["w"], meta["b"],
                                             meta["rm"], meta["rv"], EPS, MOMENTUM, True)
    with pytest.raises(ValueError, match="per-channel"):
        torch.ops.mpa.batch_norm_act.default(meta["x"], meta["w"][:5], meta["b"], meta["rm"],
                                             meta["rv"], EPS, MOMENTUM, True)
    with pytest.raises(ValueError, match="1 <= R"):
        torch.ops.mpa.batch_norm_act.default(torch.empty((0, C), device="meta"), meta["w"],
                                             meta["b"], meta["rm"], meta["rv"], EPS, MOMENTUM,
                                             True)
    with pytest.raises(ValueError, match="dy"):
        torch.ops.mpa.batch_norm_act_bwd.default(torch.empty((R + 1, C), device="meta"),
                                                 meta["x"], meta["w"], meta["b"], mean, rstd,
                                                 True)
    assert kernels.NORM_LAUNCHES == {name: 0 for name in kernels.NORM_KERNELS}


def test_a_cuda_tensor_of_another_type_raises_rather_than_falls_back(monkeypatch):
    """The dispatcher launches or raises on a card tensor: float64 rows there
    reach the op's checks (here a meta tensor stands in for the card's)."""
    monkeypatch.setattr(bn, "on_cuda", lambda t, name=None: True)
    x = torch.empty((4, 8), device="meta", dtype=torch.float64)
    stats = [torch.empty(8, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="float32"):
        bn.batch_norm_act(x, *stats, EPS, MOMENTUM, True)
