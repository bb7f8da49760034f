"""Faults planted underneath the timed path, for the tests that show the
check catches them and for the readings that set the limits: each wraps the
program's step or serve call as the harness hands it over."""

from __future__ import annotations

import torch


def unchanged(trainer):
    """A step that returns the state unchanged: the optimizer never moves."""
    trainer.state.optimizer.step = lambda *a, **k: None
    return trainer.step


def half_batch(trainer):
    """Half of the batch left out, the loss's mean taken over the rest."""

    def step(inputs, labels):
        half = labels.shape[0] // 2
        if isinstance(inputs, tuple):
            inputs = tuple(x[:half] for x in inputs)
        else:
            inputs = inputs[:half]
        return trainer.step(inputs, labels[:half])

    return step


def altered(call):
    """One cloud's answer altered where it is produced: its classes rolled."""

    def altered_call(request):
        out = call(request).clone()
        out[0] = torch.roll(out[0], 1, dims=-1)
        return out

    return altered_call


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
def altered_quarter(call):
    """The last quarter of each cloud's answers altered where they are
    produced, their classes rolled: of a per-point answer, the last quarter
    of each cloud's points (a kernel's tail tiles gone wrong); of a
    per-cloud answer, the last quarter of the clouds."""

    def altered_call(request):
        out = call(request).clone()
        rows = out[:, -(out.shape[1] // 4):] if out.dim() == 3 else out[-(out.shape[0] // 4):]
        rows.copy_(torch.roll(rows, 1, dims=-1))
        return out

    return altered_call


SERVE = {"altered": altered, "altered_quarter": altered_quarter}
