"""The kernel entries as ``torch.library`` custom ops, namespace ``mpa``.

Each hand-written kernel's entry is an op ``mpa::NAME`` with a typed schema,
a CUDA implementation (the launcher: its checks, its form, the launch and
:func:`mpa_tpu_torch.kernels.launched`) and a fake (shapes, dtypes and
strides only, from the same shape checks). ``torch.export`` traces a model
on the card through them with fake tensors, which have no storage: every
``data_ptr()`` read (the forms, the alignment copies) lies in an
implementation, and a fake call launches and counts nothing. A program
exported through them calls ``mpa::*`` ops, so it loads only in a process
that has imported ``mpa_tpu_torch.ops`` (``serve/export.py``).

The ops are registered with ``torch.library.Library.define`` and ``impl``
for the ``CUDA`` dispatch key: one Python kernel under the dispatcher, no
autograd kernel. The ``torch.autograd.Function`` wrappers of each module
keep the gradients and call the ops from their ``forward`` and ``backward``,
where grad mode is off; a call that needs no gradient (every served
request) calls the op directly. An op never returns a tensor that aliases
an input.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "mpa"
# The module that registers every op: an exported program needs it imported.
REGISTERED_BY = "mpa_tpu_torch.ops"

_LIB = torch.library.Library(NAMESPACE, "DEF")
OPS = []  # the ops' names, in the order they were defined


def define(schema: str, impl: Callable, fake: Callable) -> torch._ops.OpOverload:
    """Define ``mpa::`` + ``schema`` (``"name(args) -> returns"``), with
    ``impl`` as its CUDA kernel and ``fake`` as its fake; returns the op."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    OPS.append(name)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on ``tensors``: grad mode on and
    one of them requiring a gradient."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def kernel_device(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where an op's checks take it: on a CUDA device, or
    on the meta device, where a fake checks shapes and types alone."""
    return t.device.type in ("cuda", "meta")


def check_device(name: str, *tensors) -> None:
    """Raise ValueError unless every tensor given (None skipped) lies where
    an op takes it (:func:`kernel_device`): the ops have no CPU kernel."""
    for t in tensors:
        if t is not None and not kernel_device(t):
            raise ValueError(f"{name}: tensors must lie on a CUDA device, got one on {t.device}")
