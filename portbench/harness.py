"""One run of one cell: set-up, the measured window, the traced span, the
check against the reference, and the result.

Set-up builds everything from the seed: the traffic pool (the cell's
generator), the weights (one draw on the card, ``weights.py``), the
program's object through its normal entry, and, for a served cell, the
BatchNorm statistics (the reference's train-mode statistics on a
calibration batch, loaded into both; the reference's seconds there are
left out of ``setup_s``). A train cell's set-up drives the
program's step through the window's own feed for the checked steps, which
also warms every shape; a served cell answers two requests, and its one
client receives each answer into a pinned host buffer. The window then
runs for ``seconds``; with ``trace``, ``profile_units`` more units follow it
under the profiler and one more unit records the program's kernel inputs.
Once the program's state is freed, the reference works the checked units
out again and the numbers of ``check.py`` decide ``correct``.

``control=True`` puts the reference computed in TF32 in the program's
place (no window): the check then has to fail.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import check, program, roofline, tracing, weights
from portbench.reference import ops
from portbench.reference import train as rtrain
from portbench.reference.layers import calibrate, weight_table
from portbench.spec import Cell


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traffic(cell: Cell, clouds: int, seed: int, stream: str) -> Dict[str, np.ndarray]:
    return cell.generator().make(clouds, cell.params["points"], weights.derive(seed, stream),
                                 cell.params)


def _settle() -> None:
    """Collect the set-up's garbage and move what survives out of the
    collector's reach (``gc.freeze``), so that no full collection over the
    set-up's objects lands in the window, as a long-running server arranges
    after its warm-up."""
    gc.collect()
    gc.freeze()


def _reference(cell: Cell, wts: Dict[str, torch.Tensor], device: torch.device):
    model = cell.config().reference(cell.sizes).to(device)
    model.load_state_dict(wts)
    return model


class Run:
    """A run's state and readings: :meth:`numbers` runs it and returns the
    numbers the check compares."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, started: Callable[[], float],
                 fault: Optional[Callable] = None, control: bool = False):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.started, self.fault, self.control = device, started, fault, control
        self.p = cell.params
        self.mod = cell.config()
        self.spans = tracing.Spans()
        self.measured: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.record: dict = {}
        self.memory_peak = 0
        self.reference_s = 0.0  # the reference's seconds in set-up, not the program's

    # -- training ---------------------------------------------------------

    def train(self) -> Dict[str, float]:
        p, mod, dev, sizes = self.p, self.mod, self.device, self.cell.sizes
        B, steps = p["batch"], p["check_steps"]
        arrays = mod.train_arrays(_traffic(self.cell, B * p["pool_batches"], self.seed,
                                           "traffic"))
        table = weight_table(mod.reference(sizes))
        wts = weights.make(table, self.seed, dev)
        run_seed = weights.derive(self.seed, "train")
        if self.control:
            return self._train_control(arrays, wts, run_seed)
        trainer = program.Trainer(sizes, run_seed, B, p["pool_batches"], dev)
        weights.load_into_program(trainer.model, wts)
        step = trainer.step if self.fault is None else self.fault(trainer)
        host_batches: List[tuple] = []
        feed = trainer.feed(arrays, np.random.default_rng(weights.derive(self.seed, "order")),
                            host_batches, steps)
        try:
            first = []
            for i in range(steps):
                first.append(step(*next(feed)))
                if i == 0:
                    taken = {n: g.norm() for n, g in trainer.taken_gradients().items()}
            params = dict(trainer.model.named_parameters())
            change = {n: (params[n].detach() - wts[n]).norm() for n in params}
            prog = {"losses": [float(x) for x in first],
                    "grad": {n: float(v) for n, v in taken.items()},
                    "change": {n: float(v) for n, v in change.items()}}
            sync(dev)
            self.measured["setup_s"] = self.started()
            _settle()

            losses = []
            t0 = time.perf_counter()
            while not losses or time.perf_counter() - t0 < self.seconds:
                with self.spans("input_wait"):
                    inputs, labels = next(feed)
                with self.spans("dispatch"):
                    losses.append(step(inputs, labels))
            sync(dev)
            window = time.perf_counter() - t0
            self.attempted = len(losses)
            self.measured["train_clouds_per_s"] = len(losses) * B / window
            self._read_peak()
            if self.trace:
                def units(spans):
                    for _ in range(p["profile_units"]):
                        with spans("input_wait"):
                            x, y = next(feed)
                        with spans("dispatch"):
                            losses.append(step(x, y))
                    with spans("loss_read"):
                        torch.stack(losses[-p["profile_units"]:]).cpu()

                self._traced(units, lambda: step(*next(feed)), 3 * mod.count_ops(
                    sizes, B, p["points"])["total"])
            self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        finally:
            gc.unfreeze()
            feed.close()
        del trainer, step, feed, losses
        self._free()
        ref = self._follow(wts, host_batches, run_seed, False)
        return check.train_numbers(prog, ref)

    def _follow(self, wts, host_batches, run_seed: int, tf32: bool) -> dict:
        mod, dev, sizes = self.mod, self.device, self.cell.sizes
        model = _reference(self.cell, wts, dev)
        batches = [mod.reference_batch(b, dev) for b in host_batches]
        scope = ops.tf32_matmuls() if tf32 else contextlib.nullcontext()
        with scope:
            out = rtrain.follow(model, mod.reference_forward, batches, sizes["optimizer"],
                                run_seed, self.p["pool_batches"], sizes["augment"])
        del model
        self._free()
        return out

    def _train_control(self, arrays, wts, run_seed: int) -> Dict[str, float]:
        rng = np.random.default_rng(weights.derive(self.seed, "order"))
        B = self.p["batch"]
        order = rng.permutation(len(arrays[0]))
        host_batches = [tuple(a[order[i * B:(i + 1) * B]] for a in arrays)
                        for i in range(self.p["check_steps"])]
        self.measured["setup_s"] = self.started()
        low = self._follow(wts, host_batches, run_seed, True)
        return check.train_numbers(low, self._follow(wts, host_batches, run_seed, False))

    # -- serving ----------------------------------------------------------

    def serve(self) -> Dict[str, float]:
        p, mod, dev, sizes = self.p, self.mod, self.device, self.cell.sizes
        B, n_req = p["batch"], p["pool_requests"]
        data = _traffic(self.cell, B * n_req, self.seed, "traffic")
        pool = [{k: v[i * B:(i + 1) * B] for k, v in data.items()} for i in range(n_req)]
        wts = self._calibrated_weights()
        if dev.type == "cuda":  # the calibration is the benchmark's, not the program's
            torch.cuda.reset_peak_memory_stats(dev)
        rng = np.random.default_rng(weights.derive(self.seed, "sample"))
        if self.control:
            self.measured["setup_s"] = self.started() - self.reference_s
            return self._serve_control(pool, wts, rng)
        call, model = mod.serve_program(sizes, weights.derive(self.seed, "serve"), dev)
        weights.load_into_program(model, wts)
        if self.fault is not None:
            call = self.fault(call)
        keep, kept, latencies = p["check_requests"], [], []
        # The client's receive buffers, pinned, one for each answer kept for
        # the check and one more: an answer lands in a free one, and a
        # buffer whose answer is dropped from the sample is free again.
        free = [self._receive_buffer(call(pool[0])) for _ in range(keep + 1)]
        for i in range(2):
            free[0].copy_(call(pool[i % n_req]))
        sync(dev)
        self.measured["setup_s"] = self.started() - self.reference_s
        _settle()

        t0 = time.perf_counter()
        while len(latencies) < 2 or time.perf_counter() - t0 < self.seconds:
            i = len(latencies)
            a = time.perf_counter()
            with self.spans("dispatch"):
                out = call(pool[i % n_req])
            with self.spans("answer_copy"):
                answer = free.pop()
                answer.copy_(out)
            latencies.append(time.perf_counter() - a)
            if len(kept) < keep:
                kept.append((i % n_req, answer))
                continue
            j = int(rng.integers(0, i + 1))
            if j < keep:
                free.append(kept[j][1])
                kept[j] = (i % n_req, answer)
            else:
                free.append(answer)
        window = time.perf_counter() - t0
        self.attempted = len(latencies)
        self.measured["serve_clouds_per_s"] = len(latencies) * B / window
        q = statistics.quantiles(latencies, n=100, method="inclusive")
        self.measured["serve_p95_ms"] = 1e3 * q[94]
        self._read_peak()
        if self.trace:
            def units(spans):
                for i in range(p["profile_units"]):
                    with spans("dispatch"):
                        out = call(pool[i % n_req])
                    with spans("answer_copy"):
                        free[0].copy_(out)

            self._traced(units, lambda: free[0].copy_(call(pool[0])),
                         mod.count_ops(sizes, B, p["points"])["total"])
        gc.unfreeze()
        del call, model
        self._free()
        reference = _reference(self.cell, wts, dev).eval()
        readings = []
        for idx, out in kept:
            self.failed += int(not bool(torch.isfinite(out).all()))
            with torch.no_grad():
                want = mod.reference_forward(reference, *mod.request_tensors(pool[idx], dev))
            readings.append(mod.compare_answers(out.to(dev), want))
        return check.worst(readings)

    def _calibrated_weights(self) -> Dict[str, torch.Tensor]:
        """The weights from the seed, with each BatchNorm's running
        statistics those of a calibration batch in the reference. The
        calibration's seconds go to ``reference_s``."""
        mod, dev = self.mod, self.device
        model = mod.reference(self.cell.sizes).to(dev)
        model.load_state_dict(weights.make(weight_table(model), self.seed, dev))
        sync(dev)
        t0 = time.perf_counter()
        batch = _traffic(self.cell, self.p["calibration_clouds"], self.seed, "calibration")
        calibrate(model, lambda: mod.reference_forward(model, *mod.request_tensors(batch, dev)))
        wts = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        self._free()
        sync(dev)
        self.reference_s += time.perf_counter() - t0
        return wts

    def _serve_control(self, pool, wts, rng) -> Dict[str, float]:
        mod, dev = self.mod, self.device
        reference = _reference(self.cell, wts, dev).eval()
        readings = []
        for _ in range(self.p["check_requests"]):
            req = mod.request_tensors(pool[int(rng.integers(0, len(pool)))], dev)
            with torch.no_grad():
                want = mod.reference_forward(reference, *req)
                with ops.tf32_matmuls():
                    low = mod.reference_forward(reference, *req)
            readings.append(mod.compare_answers(low, want))
        self.attempted = len(readings)
        return check.worst(readings)

    # -- shared -----------------------------------------------------------

    def _receive_buffer(self, like: torch.Tensor) -> torch.Tensor:
        """A host buffer for an answer shaped as ``like``, pinned on a card
        (the copy then runs at the link's rate, not the host's), its pages
        touched."""
        buf = torch.zeros(like.shape, dtype=like.dtype, pin_memory=self.device.type == "cuda")
        buf.copy_(like)
        return buf

    def _read_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def _free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _traced(self, units: Callable, one_unit: Callable, ops_per_unit: int) -> None:
        """The profiled span after the window, then one unit whose kernel
        launches are recorded and bounded (their least time)."""
        from mpa_tpu_torch import kernels

        trace = tracing.profile(units)
        kernels.recorded = []
        try:
            one_unit()
            sync(self.device)
            least = sum(roofline.least_seconds(n, inp) for n, inp in kernels.recorded)
        finally:
            kernels.recorded = None
        self.record = {"kind": self.cell.kind, "units": self.p["profile_units"],
                       "trace": trace, "window_spans": list(self.spans.items),
                       "least_s_per_unit": least, "ops_per_unit": ops_per_unit,
                       "peak_flops": roofline.PEAK_FLOPS}

    def numbers(self) -> Dict[str, float]:
        return self.train() if self.cell.kind == "train" else self.serve()


def device_block(device: torch.device, memory_peak: int, record: dict) -> dict:
    if device.type != "cuda":
        block = {"platform": device.type, "kind": "cpu", "count": 0,
                 "memory_peak_bytes": 0}
    else:
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                 "memory_peak_bytes": int(memory_peak)}
    if record:
        t = record["trace"]
        block["busy_s"] = roofline.busy_seconds((a, b) for _, a, b in t["device_ops"])
        block["window_s"] = t["end"] - t["start"]
    return block


def per_layer(cell: Cell, record: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds."""
    from portbench.spec import reader_functions

    units = {m["name"]: m["unit"] for m in cell.per_layer}
    out = {}
    for name, read in reader_functions(cell).items():
        value = read(record)
        if value is not None and math.isfinite(value):
            out[name] = {"value": value, "unit": units[name]}
    return out
