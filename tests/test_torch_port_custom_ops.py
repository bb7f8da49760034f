"""The kernel entries as ``torch.library`` custom ops, on the CPU.

Each of the fourteen ops ``mpa::*`` (``mpa_tpu_torch/ops/library.py``) has a
CUDA implementation, which launches its kernel, and a fake, which
``torch.export`` calls with storage-less tensors. The CUDA implementations
run only on a card, in ``tests/test_torch_port_cuda.py``
(``torch.library.opcheck`` of each op). Here, on the CPU, for every op and
for float32 and bf16 where its kernel takes bf16 storage (the attention ops
with and without value shifts): the op called on meta tensors, which
dispatch to its fake, gives outputs of the shapes, dtypes and strides that
its plain version gives on CPU inputs of the same shapes; the call leaves
``kernels.LAUNCHES`` and ``kernels.NORM_LAUNCHES`` unchanged; and the op is registered under the
namespace an exported artifact's manifest names, with no CPU kernel (an op
given CPU tensors raises, as the wrappers never give it any).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (pins torch to one thread)

from test_torch_port_op_cases import B, C, CASES, K, N, S, SPEC, case, case_id  # noqa: E402
from test_torch_port_op_cases import PATH_CASES, path_case  # noqa: E402

from mpa_tpu_torch import kernels  # noqa: E402
from mpa_tpu_torch.ops import library  # noqa: E402
from mpa_tpu_torch.serve import export as serve_export  # noqa: E402


def _outputs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name,dtype,shifted", CASES,
                         ids=[case_id(*c) for c in CASES])
def test_fake_matches_the_plain_op_and_launches_nothing(name, dtype, shifted):
    args, want = case(name, dtype, shifted)
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    before = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BF16), dict(kernels.NORM_LAUNCHES)
    got = getattr(torch.ops.mpa, name).default(*meta)
    assert (dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BF16),
            dict(kernels.NORM_LAUNCHES)) == before
    got, want = _outputs(got), _outputs(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype, g.stride()) == (tuple(w.shape), w.dtype, w.stride())


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_fake_matches_the_plain_op_at_the_extras_shapes(case):
    """The fakes at DGCNN's and Disp3D's launch shapes (k = 20 and 16, C up
    to 128), as above."""
    name, args, want = path_case(case)
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    got = getattr(torch.ops.mpa, name).default(*meta)
    for g, w in zip(_outputs(got), _outputs(want)):
        assert (tuple(g.shape), g.dtype, g.stride()) == (tuple(w.shape), w.dtype, w.stride())


def test_fake_refuses_what_the_kernel_refuses():
    """The fake runs the kernel's shape and type checks, so a trace fails
    where a launch would."""
    base = torch.empty((B, N, C), device="meta")
    with pytest.raises(ValueError, match="k <= 64"):
        torch.ops.mpa.knn.default(65, torch.empty((B, 128, C), device="meta"),
                                  torch.empty((B, S, C), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        torch.ops.mpa.knn.default(K, base.double(), base.double())
    with pytest.raises(ValueError, match="do not tile"):
        torch.ops.mpa.windowed_knn.default(K, base, torch.empty((B, S, C), device="meta"),
                                           SPEC.sq, SPEC.bn + 8, SPEC.n_chunks)


def test_every_kernel_entry_is_an_op_of_the_manifest_namespace():
    assert serve_export.OP_NAMESPACE == library.NAMESPACE == "mpa"
    assert len(library.OPS) == len(set(library.OPS)) == 14
    assert len(kernels.KERNELS) + len(kernels.NORM_KERNELS) == 14
    for name in library.OPS:
        op = getattr(torch.ops.mpa, name).default
        assert op._schema.name == f"mpa::{name}"
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CUDA")
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CPU")
    with pytest.raises(NotImplementedError):
        torch.ops.mpa.gather.default(torch.zeros((1, 4, 2)), torch.zeros((1, 3), dtype=torch.int32))
