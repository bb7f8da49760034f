"""Morton-window neighbour search, transition attention and scatter-mean.

Counterpart of ``mpa_tpu/ops/pallas/window_attention.py``, the opt-in window
modes for large scenes. When every scale's points are kept in Morton order
(``ops/morton.py``), a query's k nearest neighbours lie in a narrow index
band, and each op works on a per-chunk window whose position is a function
of the row alone (:class:`WindowSpec`): S queries in ``n_chunks`` chunks of
``sq`` rows, padded by ``sq/2`` rows at each end so that each padded chunk
is centred on its window; padded chunk ``c`` sees the base rows ``[g*bn,
g*bn + 2*bn)``, ``g = clamp(c - 1, 0, n_chunks - 2)``. Original row ``s``
lies in padded chunk ``(s + sq/2) // sq``.

- :func:`windowed_knn_with_spec`: the k nearest inside the window
  ("k nearest within the Morton window", an approximation of exact kNN);
- :func:`windowed_transition_attention` and :func:`windowed_scatter_mean`:
  the exact ops' functions, for an index that lies in its row's window.

bf16 storage (the mixed precision models'): the attention and the
scatter-mean keep bf16 rows bf16 on both devices, as the exact ops do
(``ops/attention.py``, ``ops/scatter.py``): float32 arithmetic and sums, the
context, ``dpacked``, ``dshift`` and the mean rounded to bf16 once
(``window_attention.py:311,353,465-466,504,581,674``). The windowed kNN
widens bf16 rows to float32 before any distance, as ``mpa_tpu``'s kernel
does (``:166-168``) and as the exact kNN does (``ops/knn.py``):
``windowed_knn_kernel`` stays float32, and the distances are float32.

On a CUDA tensor each is a ``torch.autograd.Function`` over a hand-written
kernel (``kernels/csrc/window_*.cu``: ``windowed_knn_kernel``,
``windowed_attention_fwd_kernel`` / ``windowed_attention_bwd_kernel``,
``windowed_scatter_mean_kernel``); on a CPU tensor it takes the plain
version: :func:`windowed_knn_plain`, and for the other two the exact ops'
plain versions, which compute the same function for any index, as
``mpa_tpu`` takes its generic references off the TPU.

An index outside its row's window is a caller error (the windowed kNN never
makes one). The attention kernels still read such a row, from device
memory; the scatter-mean kernel sees such a claim only where its row lies
among the rows that can claim the block's slots (:func:`block_claim_rows`).
:func:`check_in_window` checks an index with torch ops (``chip_smoke.py``
checks every recorded one).

The kernels' entries are the custom ops ``mpa::windowed_knn``,
``mpa::windowed_attention``, ``mpa::windowed_attention_bwd`` and
``mpa::windowed_scatter_mean`` (``ops/library.py``), the spec passed as its
ints ``(sq, bn, n_chunks)``; the ``*_cuda`` functions call them, and the
model-facing functions call the forwards directly where no gradient is
needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.ops.attention import (
    attention_bwd_fake, attention_fake, attention_fwd_form, transition_attention,
)
from mpa_tpu_torch.ops.attention import check_args as check_attention
from mpa_tpu_torch.ops.attention import check_cuda_args as check_attention_cuda
from mpa_tpu_torch.ops.gather import (
    KERNEL_DTYPES, MIN_ROW_SLOTS, index_form, partial_sums, stored,
)
from mpa_tpu_torch.ops.knn import MAX_C, aligned, knn_distance_grads
from mpa_tpu_torch.ops.pairwise import dot_in_channel_order
from mpa_tpu_torch.ops.scatter import scatter_mean_bwd_cuda, scatter_mean_fake, scatter_mean_plain
from mpa_tpu_torch.ops.scatter import check_args as check_scatter
from mpa_tpu_torch.ops.scatter import check_cuda_args as check_scatter_cuda
from mpa_tpu_torch.utils import profiling
from mpa_tpu_torch.utils.device import on_cuda

# windowed_knn_kernel's limits: each thread's list of k in registers (32
# pairs at most), knn_kernel's channels.
MAX_KNN_K = 32
MAX_KNN_C = MAX_C
# windowed_knn_kernel's resident form (knn_search.cuh): C <= 8 and the
# window, rounded up to 64 rows, with its norms in 96 KB.
RESIDENT_C = 8
RESIDENT_BYTES = 96 * 1024
# Threads that fill the H100's 132 SMs (about 500 an SM) in the resident
# form.
FILL_THREADS = 1 << 16


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Banding contract shared by the windowed ops: S queries and N nodes,
    both Morton-ordered; ``n_chunks`` chunks of ``sq`` queries and as many
    node blocks of ``bn``."""

    S: int
    N: int
    sq: int
    bn: int
    n_chunks: int

    @property
    def window(self) -> int:
        return 2 * self.bn

    @property
    def pad(self) -> int:
        return self.sq // 2

    def window_start(self, device=None) -> torch.Tensor:
        """``[S]`` int64: the first window row of every query row."""
        s = torch.arange(self.S, device=device)
        g = torch.clamp((s + self.pad) // self.sq - 1, 0, self.n_chunks - 2)
        return g * self.bn


def make_window_spec(S: int, N: int, sq: int = 128) -> WindowSpec:
    """The spec for S queries over N nodes. Requires the models' power-of-two
    scales: ``S % sq == 0`` (``sq`` capped at ``S // 2``), at least two
    chunks, ``N`` divisible by the chunk count, ``bn`` and ``sq`` multiples
    of 8; raises ValueError otherwise (``window_attention.py:93-107``)."""
    sq = min(sq, S // 2)
    if sq <= 0 or S % sq:
        raise ValueError(f"S={S} not divisible by sq={sq}")
    n_chunks = S // sq
    if n_chunks < 2:
        raise ValueError(f"need >= 2 chunks (S={S}, sq={sq})")
    if N % n_chunks:
        raise ValueError(f"N={N} not divisible by n_chunks={n_chunks}")
    bn = N // n_chunks
    if bn % 8 or sq % 8:
        raise ValueError(f"bn={bn} and sq={sq} must be multiples of 8")
    return WindowSpec(S=S, N=N, sq=sq, bn=bn, n_chunks=n_chunks)


def check_in_window(idx: torch.Tensor, spec: WindowSpec, what: str) -> None:
    """Raise ValueError unless every ``idx[b, s, :]`` lies in row s's window."""
    if tuple(idx.shape[1:2]) != (spec.S,):
        raise ValueError(f"{what}: idx has {idx.shape[1]} rows, the spec {spec.S}")
    win0 = spec.window_start(idx.device)[None, :, None]
    outside = (idx < win0) | (idx >= win0 + spec.window)
    profiling.host_sync("window.check")
    if bool(outside.any()):
        raise ValueError(f"{what}: {int(outside.sum())} indices lie outside their rows' "
                         f"windows ({spec})")


def claim_rows(spec: WindowSpec, n: int) -> Tuple[int, int]:
    """The query rows ``[lo, hi)`` whose windows can contain fine slot ``n``
    (``kernels/csrc/window.cuh::claim_rows``): n lies in base block ``j = n
    // bn``, which only the windows ``j - 1`` and ``j`` contain, and the
    padded chunks with those windows are consecutive."""
    j = n // spec.bn
    g_lo, g_hi = max(j - 1, 0), min(j, spec.n_chunks - 2)
    c_lo = 0 if g_lo == 0 else g_lo + 1
    c_hi = spec.n_chunks if g_hi == spec.n_chunks - 2 else g_hi + 1
    return max(c_lo * spec.sq - spec.pad, 0), min((c_hi + 1) * spec.sq - spec.pad, spec.S)


def block_claim_rows(spec: WindowSpec, n0: int, slots: int) -> Tuple[int, int]:
    """The query rows ``[lo, hi)`` that ``windowed_scatter_mean_kernel``'s
    block of slots ``[n0, n0 + slots)`` reads (:func:`claim_rows` is
    nondecreasing in n, so the union of its slots' ranges is one range)."""
    n1 = min(n0 + slots, spec.N) - 1
    return claim_rows(spec, n0)[0], claim_rows(spec, n1)[1]


def _spec_for(spec: WindowSpec, S: int, N: int, what: str) -> None:
    if (spec.S, spec.N) != (S, N):
        raise ValueError(f"{what}: the spec is for (S, N) = ({spec.S}, {spec.N}), "
                         f"the call has ({S}, {N})")


def _spec_args(spec: WindowSpec):
    return spec.sq, spec.bn, spec.n_chunks


def _spec_from(S: int, N: int, sq: int, bn: int, n_chunks: int, what: str) -> WindowSpec:
    """The spec an op's ints ``(sq, bn, n_chunks)`` give for S queries over N
    nodes; raises ValueError unless they tile both."""
    if n_chunks < 2 or sq * n_chunks != S or bn * n_chunks != N:
        raise ValueError(f"{what}: sq={sq}, bn={bn}, n_chunks={n_chunks} do not tile "
                         f"(S, N) = ({S}, {N})")
    return WindowSpec(S=S, N=N, sq=sq, bn=bn, n_chunks=n_chunks)


# -- the windowed kNN ------------------------------------------------------------


def direct_distance(base: torch.Tensor, query: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``sum_c (q_c - b[idx]_c)^2`` in channel order, ``[B, S, k]``,
    differentiable in ``base`` and ``query``."""
    B, S, k = idx.shape
    C = base.shape[-1]
    rows = torch.gather(base.float(), 1, idx.reshape(B, S * k, 1).long().expand(-1, -1, C))
    diff = query.float()[:, :, None, :] - rows.reshape(B, S, k, C)
    return dot_in_channel_order(diff, diff)


def windowed_knn_plain(
    k: int, base: torch.Tensor, query: torch.Tensor, spec: WindowSpec
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, ``window_attention.py::windowed_knn_reference`` chunk by
    chunk: ``d = (|q|^2 + |b|^2) - 2 q.b`` over the chunk's window (each dot
    product in channel order, not clamped at 0), a stable ascending sort, so
    ties go to the lowest index, and the k first as global indices. Returns
    ``(direct-form distances [B,S,k] f32, idx [B,S,k] int32)``."""
    B, N, C = base.shape
    nc, sq, bn, pad = spec.n_chunks, spec.sq, spec.bn, spec.pad
    with torch.no_grad():
        b = base.detach().float()
        qp = F.pad(query.detach().float(), (0, 0, pad, pad)).reshape(B, nc + 1, sq, C)
        win0 = torch.clamp(torch.arange(nc + 1, device=b.device) - 1, 0, nc - 2) * bn
        rows = win0[:, None] + torch.arange(spec.window, device=b.device)  # [nc+1, 2bn]
        band = b[:, rows]  # [B, nc+1, 2bn, C]
        q2 = dot_in_channel_order(qp, qp)
        b2 = dot_in_channel_order(band, band)
        cross = dot_in_channel_order(qp.unsqueeze(-2), band.unsqueeze(-3))  # [B, nc+1, sq, 2bn]
        d = (q2.unsqueeze(-1) + b2.unsqueeze(-2)) - 2.0 * cross
        local = torch.sort(d, dim=-1, stable=True)[1][..., :k]
        idx = (local + win0[None, :, None, None]).reshape(B, (nc + 1) * sq, k)
        idx = idx[:, pad:pad + spec.S].to(torch.int32).contiguous()
    return direct_distance(base, query, idx), idx


def _check_knn(k: int, base: torch.Tensor, query: torch.Tensor, spec: WindowSpec) -> None:
    if base.dim() != 3 or query.dim() != 3 or base.shape[0] != query.shape[0] \
            or base.shape[2] != query.shape[2]:
        raise ValueError(f"windowed kNN: base [B,N,C] and query [B,S,C] expected, got "
                         f"{tuple(base.shape)}, {tuple(query.shape)}")
    _spec_for(spec, query.shape[1], base.shape[1], "windowed kNN")
    if not 1 <= k <= spec.window:
        raise ValueError(f"windowed kNN: k={k} must be in [1, window={spec.window}]")


def windowed_knn_form(B: int, C: int, spec: WindowSpec) -> Tuple[bool, int]:
    """``windowed_knn_kernel``'s form for ``B`` clouds of ``C`` channels under
    ``spec``: ``(resident, par)``, fixed by the shape. ``mpa_windowed_knn``
    refuses any other form.

    Resident (C <= 8 and the window, rounded up to 64 rows, with its norms
    within ``RESIDENT_BYTES``): ``par`` threads a query, the fewest (a power
    of two, at most 32 and at most one for every 4 window rows) that give
    ``FILL_THREADS`` threads. Streaming (every other shape): ``par`` = 4
    queries a thread (64 a block) where 16 <= C <= 128 and that gives 128
    blocks (``knn_kernel`` picks 4 from 256: a window's blocks are shorter);
    else 1 (16 a block)."""
    nps = -(-spec.window // 64) * 64
    if C <= RESIDENT_C and 4 * (C + 1) * nps <= RESIDENT_BYTES:
        lanes = 1
        while lanes < 32 and 4 * lanes < spec.window and B * spec.S * lanes < FILL_THREADS:
            lanes *= 2
        return True, lanes
    wide = 16 <= C <= 128 and B * spec.n_chunks * -(-spec.sq // 64) >= 128
    return False, 4 if wide else 1


def _check_knn_kernel(k: int, base: torch.Tensor, query: torch.Tensor, spec: WindowSpec) -> None:
    _check_knn(k, base, query, spec)
    C = base.shape[2]
    if k > MAX_KNN_K or C > MAX_KNN_C:
        raise ValueError(f"windowed_knn_kernel supports k <= {MAX_KNN_K} and C <= {MAX_KNN_C}, "
                         f"got k={k}, C={C}")
    for name, t in (("base", base), ("query", query)):
        if not library.kernel_device(t) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"windowed_knn_kernel: {name} must be a contiguous float32 CUDA tensor")
    if base.device != query.device:
        raise ValueError("windowed_knn_kernel: base and query on different devices")


def _windowed_knn_impl(k: int, base: torch.Tensor, query: torch.Tensor, sq: int, bn: int,
                       n_chunks: int):
    """``mpa::windowed_knn`` on the card: launch ``windowed_knn_kernel`` in
    :func:`windowed_knn_form`'s form; a view off a 16-byte boundary is
    copied first (the streaming form reads rows as float4s)."""
    spec = _spec_from(query.shape[1], base.shape[1], sq, bn, n_chunks, "windowed_knn_kernel")
    _check_knn_kernel(k, base, query, spec)
    base, query = aligned(base), aligned(query)
    B, N, C = base.shape
    S = query.shape[1]
    resident, par = windowed_knn_form(B, C, spec)
    dist = torch.empty((B, S, k), dtype=torch.float32, device=base.device)
    idx = torch.empty((B, S, k), dtype=torch.int32, device=base.device)
    lib = build.load()
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_windowed_knn(base.data_ptr(), query.data_ptr(), dist.data_ptr(),
                                 idx.data_ptr(), B, N, S, C, k, *_spec_args(spec), int(resident),
                                 par, stream),
            f"windowed_knn_kernel (B={B}, C={C}, {spec}, resident={resident}, par={par})",
        )
    kernels.launched("windowed_knn_kernel", {"k": k, "base": base, "query": query, "spec": spec})
    return dist, idx


def _windowed_knn_fake(k: int, base: torch.Tensor, query: torch.Tensor, sq: int, bn: int,
                       n_chunks: int):
    spec = _spec_from(query.shape[1], base.shape[1], sq, bn, n_chunks, "windowed_knn_kernel")
    _check_knn_kernel(k, base, query, spec)
    shape = (base.shape[0], query.shape[1], k)
    return base.new_empty(shape), base.new_empty(shape, dtype=torch.int32)


windowed_knn_op = library.define(
    "windowed_knn(int k, Tensor base, Tensor query, SymInt sq, SymInt bn, SymInt n_chunks) "
    "-> (Tensor, Tensor)", _windowed_knn_impl, _windowed_knn_fake)


def windowed_knn_cuda(
    k: int, base: torch.Tensor, query: torch.Tensor, spec: WindowSpec
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``windowed_knn_kernel`` on contiguous float32 CUDA tensors, through
    ``mpa::windowed_knn``."""
    library.check_device("windowed_knn_kernel", base, query)
    return windowed_knn_op(k, base, query, *_spec_args(spec))


class _WindowedKnnCuda(torch.autograd.Function):
    """``windowed_knn_kernel`` forward; the backward of the direct-form
    distances through the row gather and scatter-add kernels, as ``knn``'s."""

    @staticmethod
    def forward(ctx, k: int, base: torch.Tensor, query: torch.Tensor, spec: WindowSpec):
        dist, idx = windowed_knn_cuda(k, base, query, spec)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(base, query, idx)
        return dist, idx

    @staticmethod
    @once_differentiable
    def backward(ctx, g_dist: torch.Tensor, _g_idx):
        base, query, idx = ctx.saved_tensors
        d_base, d_query = knn_distance_grads(base, query, idx, g_dist, ctx.needs_input_grad[1],
                                             ctx.needs_input_grad[2])
        return None, d_base, d_query, None


def windowed_knn_with_spec(
    k: int, base: torch.Tensor, query: torch.Tensor, sq: int = 128
) -> Tuple[torch.Tensor, torch.Tensor, WindowSpec]:
    """The k nearest base rows of each query inside its chunk's Morton window.

    Args:
      k: neighbours per query (``<= 32`` on CUDA).
      base: ``[B, N, C]``, Morton-ordered.
      query: ``[B, S, C]``, in the same Morton-consistent order.
      sq: chunk rows before the cap at ``S // 2``.

    Returns:
      ``(sqr_dists [B,S,k], idx [B,S,k] int32, spec)``: ascending within the
      window, ties to the lowest index, global indices; the distances
      recomputed in direct form from the selected rows and differentiable;
      ``spec`` is the window the search used, for the attention and
      scatter-mean that follow. Raises ValueError (from
      :func:`make_window_spec`) when the scale pair admits no window.

    Each search counts one in ``COUNTS["knn.windowed"]``
    (``utils/profiling.py``).
    """
    spec = make_window_spec(query.shape[1], base.shape[1], sq=sq)
    profiling.COUNTS["knn.windowed"] += 1
    if on_cuda(base, "base"):
        base, query = base.float().contiguous(), query.float().contiguous()
        if library.needs_grad(base, query):
            dist, idx = _WindowedKnnCuda.apply(k, base, query, spec)
        else:
            dist, idx = windowed_knn_cuda(k, base, query, spec)
        return dist, idx, spec
    _check_knn(k, base, query, spec)
    dist, idx = windowed_knn_plain(k, base, query, spec)
    return dist, idx, spec


# -- the windowed transition attention --------------------------------------------------


def _windowed_attention_impl(packed, idx, shifts, n_branches: int, c: int, sq: int, bn: int,
                             n_chunks: int) -> torch.Tensor:
    """``mpa::windowed_attention`` on the card: launch
    ``windowed_attention_fwd_kernel`` (float32, or bf16 ``packed`` and
    ``shifts`` for a bf16 context), with ``attention_fwd_form``'s channels a
    thread; the function of ``attention_plain``."""
    name = "windowed_attention_fwd_kernel"
    spec = _spec_from(idx.shape[1], packed.shape[1], sq, bn, n_chunks, name)
    check_attention_cuda(name, packed, idx, shifts, n_branches, c, None, dtypes=KERNEL_DTYPES)
    B, N, _ = packed.shape
    S, K = idx.shape[1], idx.shape[2]
    vec = attention_fwd_form(packed, shifts, K, c)
    bf16 = packed.dtype == torch.bfloat16
    out = torch.empty((B, S, n_branches * c), dtype=packed.dtype, device=packed.device)
    lib = build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_windowed_attention_fwd(
                packed.data_ptr(), idx.data_ptr(),
                None if shifts is None else shifts.data_ptr(), out.data_ptr(),
                B, N, S, K, n_branches, c, vec, int(bf16), stream),
            f"{name} (K={K}, c={c}, {vec} channels a thread)",
        )
    kernels.launched(name, {"packed": packed, "idx": idx, "shifts": shifts,
                            "n_branches": n_branches, "c": c, "spec": spec}, bf16=bf16)
    return out


def _windowed_attention_fake(packed, idx, shifts, n_branches: int, c: int, sq: int, bn: int,
                             n_chunks: int) -> torch.Tensor:
    name = "windowed_attention_fwd_kernel"
    _spec_from(idx.shape[1], packed.shape[1], sq, bn, n_chunks, name)
    return attention_fake(name, packed, idx, shifts, n_branches, c)


windowed_attention_op = library.define(
    "windowed_attention(Tensor packed, Tensor idx, Tensor? shifts, int n_branches, int c, "
    "SymInt sq, SymInt bn, SymInt n_chunks) -> Tensor",
    _windowed_attention_impl, _windowed_attention_fake)


def windowed_attention_cuda(packed, idx, shifts, n_branches: int, c: int,
                            spec: WindowSpec) -> torch.Tensor:
    """``windowed_attention_fwd_kernel`` through ``mpa::windowed_attention``;
    the function of ``attention_plain``."""
    library.check_device("windowed_attention_fwd_kernel", packed, idx, shifts)
    return windowed_attention_op(packed, idx, shifts, n_branches, c, *_spec_args(spec))


def _windowed_attention_bwd_impl(packed, idx, shifts, gctx, n_branches: int, c: int, sq: int,
                                 bn: int, n_chunks: int):
    """``mpa::windowed_attention_bwd`` on the card: launch
    ``windowed_attention_bwd_kernel``; returns ``(dpacked, dshift or None)``,
    the function of ``attention_bwd_plain``. For bf16 ``packed``, ``shifts``
    and ``gctx`` the kernel adds into a float32 ``dpacked`` and rounds it
    into the bf16 one it returns."""
    name = "windowed_attention_bwd_kernel"
    spec = _spec_from(idx.shape[1], packed.shape[1], sq, bn, n_chunks, name)
    check_attention_cuda(name, packed, idx, shifts, n_branches, c, gctx, dtypes=KERNEL_DTYPES)
    B, N, W = packed.shape
    S, K = idx.shape[1], idx.shape[2]
    bf16 = packed.dtype == torch.bfloat16
    acc = torch.empty((B, N, W), dtype=torch.float32, device=packed.device)
    dpacked = torch.empty_like(packed) if bf16 else acc
    dshift = None if shifts is None else torch.empty_like(shifts)
    lib = build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_windowed_attention_bwd(
                packed.data_ptr(), idx.data_ptr(),
                None if shifts is None else shifts.data_ptr(), gctx.data_ptr(),
                acc.data_ptr(), dpacked.data_ptr() if bf16 else None,
                None if dshift is None else dshift.data_ptr(),
                B, N, S, K, n_branches, c, int(bf16), stream),
            name,
        )
    kernels.launched(name, {"packed": packed, "idx": idx, "shifts": shifts, "gctx": gctx,
                            "n_branches": n_branches, "c": c, "spec": spec}, bf16=bf16)
    return dpacked, dshift


def _windowed_attention_bwd_fake(packed, idx, shifts, gctx, n_branches: int, c: int, sq: int,
                                 bn: int, n_chunks: int):
    name = "windowed_attention_bwd_kernel"
    _spec_from(idx.shape[1], packed.shape[1], sq, bn, n_chunks, name)
    return attention_bwd_fake(name, packed, idx, shifts, gctx, n_branches, c)


windowed_attention_bwd_op = library.define(
    "windowed_attention_bwd(Tensor packed, Tensor idx, Tensor? shifts, Tensor gctx, "
    "int n_branches, int c, SymInt sq, SymInt bn, SymInt n_chunks) -> (Tensor, Tensor?)",
    _windowed_attention_bwd_impl, _windowed_attention_bwd_fake)


def windowed_attention_bwd_cuda(packed, idx, shifts, gctx, n_branches: int, c: int,
                                spec: WindowSpec) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``windowed_attention_bwd_kernel`` through
    ``mpa::windowed_attention_bwd``; returns ``(dpacked, dshift or None)``,
    the function of ``attention_bwd_plain``."""
    library.check_device("windowed_attention_bwd_kernel", packed, idx, shifts, gctx)
    return windowed_attention_bwd_op(packed, idx, shifts, gctx, n_branches, c, *_spec_args(spec))


class _WindowedAttention(torch.autograd.Function):
    """``windowed_attention_fwd_kernel`` forward,
    ``windowed_attention_bwd_kernel`` backward (``_wattn``'s custom VJP).
    Saves the node tensors, not the gathered edge rows."""

    @staticmethod
    def forward(ctx, packed, idx, shifts, n_branches: int, c: int, spec: WindowSpec):
        ctx.save_for_backward(packed, idx, shifts)
        ctx.n_branches, ctx.c, ctx.spec = n_branches, c, spec
        return windowed_attention_cuda(packed, idx, shifts, n_branches, c, spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, gctx):
        packed, idx, shifts = ctx.saved_tensors
        dpacked, dshift = windowed_attention_bwd_cuda(
            packed, idx, shifts, gctx.to(packed.dtype).contiguous(), ctx.n_branches, ctx.c,
            ctx.spec)
        return dpacked, None, dshift, None, None, None


def windowed_transition_attention(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    n_branches: int,
    c: int,
    spec: WindowSpec,
) -> torch.Tensor:
    """``transition_attention`` (same arguments and result, bf16 storage
    included) for an ``idx`` inside its rows' windows of ``spec``, the
    windowed kNN's guarantee. On a CPU tensor it is that op's plain path."""
    bf16 = packed.dtype == torch.bfloat16
    if bf16 and shifts is not None and shifts.dtype != packed.dtype:
        raise ValueError(f"windowed attention: bf16 packed needs bf16 shifts, got {shifts.dtype}")
    if on_cuda(packed, "packed"):
        store = torch.bfloat16 if bf16 else torch.float32
        args = (packed.to(store).contiguous(), idx.to(torch.int32).contiguous(),
                None if shifts is None else shifts.to(store).contiguous(), n_branches, c, spec)
        if library.needs_grad(args[0], args[2]):
            return _WindowedAttention.apply(*args).to(packed.dtype)
        return windowed_attention_cuda(*args).to(packed.dtype)
    check_attention(packed, idx, shifts, n_branches, c)
    _spec_for(spec, idx.shape[1], packed.shape[1], "windowed attention")
    return transition_attention(packed, idx, shifts, n_branches, c)


# -- the windowed scatter-mean -------------------------------------------------------------


def windowed_scatter_mean_form(features: torch.Tensor, num_fine: int) -> Tuple[int, int]:
    """``windowed_scatter_mean_kernel``'s form ``(slots, vec)``:
    ``ops/gather.py::index_form``'s, with the slots halved down to 8, not
    32, while the launch is short of blocks. A block reads only the rows
    that can claim its slots, so a smaller block costs no more index reads.
    The kernel's entry refuses any other form."""
    return index_form(features, num_fine, min_slots=MIN_ROW_SLOTS)


def _windowed_scatter_mean_impl(features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int,
                                sq: int, bn: int, n_chunks: int):
    """``mpa::windowed_scatter_mean`` on the card: launch
    ``windowed_scatter_mean_kernel`` in :func:`windowed_scatter_mean_form`'s
    form: features ``[B,S,C]`` f32 or bf16 -> ``(mean [B,N,C]`` of the
    features' type``, count [B,N]`` f32), the function of
    ``scatter_mean_plain`` for an in-window index."""
    name = "windowed_scatter_mean_kernel"
    spec = _spec_from(features.shape[1], num_fine, sq, bn, n_chunks, name)
    check_scatter_cuda(name, features, knn_idx, num_fine)
    B, S, C = features.shape
    K = knn_idx.shape[2]
    slots, vec = windowed_scatter_mean_form(features, num_fine)
    bf16 = features.dtype == torch.bfloat16
    out = torch.empty((B, num_fine, C), dtype=features.dtype, device=features.device)
    count = torch.empty((B, num_fine), dtype=torch.float32, device=features.device)
    part = partial_sums(out, S * K)
    lib = build.load()
    with torch.cuda.device(features.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_windowed_scatter_mean(features.data_ptr(), knn_idx.data_ptr(), out.data_ptr(),
                                          None if part is None else part.data_ptr(),
                                          count.data_ptr(), B, S, K, num_fine, C, slots, vec,
                                          *_spec_args(spec), int(bf16), stream),
            f"{name} ({slots} slots a block, {vec} channels a lane)",
        )
    kernels.launched(name, {"features": features, "knn_idx": knn_idx, "num_fine": num_fine,
                            "spec": spec}, bf16=bf16)
    return out, count


def _windowed_scatter_mean_fake(features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int,
                                sq: int, bn: int, n_chunks: int):
    name = "windowed_scatter_mean_kernel"
    _spec_from(features.shape[1], num_fine, sq, bn, n_chunks, name)
    return scatter_mean_fake(name, features, knn_idx, num_fine)


windowed_scatter_mean_op = library.define(
    "windowed_scatter_mean(Tensor features, Tensor knn_idx, SymInt num_fine, SymInt sq, "
    "SymInt bn, SymInt n_chunks) -> (Tensor, Tensor)",
    _windowed_scatter_mean_impl, _windowed_scatter_mean_fake)


def windowed_scatter_mean_cuda(features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int,
                               spec: WindowSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """``windowed_scatter_mean_kernel`` through ``mpa::windowed_scatter_mean``:
    features ``[B,S,C]`` f32 or bf16 -> ``(mean [B,N,C]`` of the features'
    type``, count [B,N]`` f32), the function of ``scatter_mean_plain`` for an
    in-window index."""
    library.check_device("windowed_scatter_mean_kernel", features, knn_idx)
    return windowed_scatter_mean_op(features, knn_idx, num_fine, *_spec_args(spec))


class _WindowedScatterMean(torch.autograd.Function):
    """``windowed_scatter_mean_kernel`` forward; the backward of the exact
    op (``window_attention.py::_wscatter_bwd``): the gradient divided by
    the count, gathered through ``gather_rows_kernel``, summed over K, all
    in float32 (a bf16 gradient over the float32 count is float32), and
    rounded once to the gradient's type."""

    @staticmethod
    def forward(ctx, features, knn_idx, num_fine: int, spec: WindowSpec):
        out, count = windowed_scatter_mean_cuda(features, knn_idx, num_fine, spec)
        ctx.save_for_backward(knn_idx, count)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        knn_idx, count = ctx.saved_tensors
        return stored(scatter_mean_bwd_cuda(grad, knn_idx, count), grad), None, None, None


def windowed_scatter_mean(features: torch.Tensor, knn_idx: torch.Tensor, num_fine: int,
                          spec: WindowSpec) -> torch.Tensor:
    """``scatter_mean_upsample`` (same arguments and result) for a
    ``knn_idx`` inside its coarse rows' windows of ``spec``, the windowed
    kNN's guarantee (differentiable in ``features``; bf16 features give a
    bf16 mean, the float32 one rounded once)."""
    check_scatter(features, knn_idx, num_fine)
    if on_cuda(features, "features"):
        rows = (features if features.dtype == torch.bfloat16 else features.float()).contiguous()
        idx = knn_idx.to(torch.int32).contiguous()
        if library.needs_grad(rows):
            return _WindowedScatterMean.apply(rows, idx, num_fine, spec).to(features.dtype)
        return windowed_scatter_mean_cuda(rows, idx, num_fine, spec)[0].to(features.dtype)
    _spec_for(spec, features.shape[1], num_fine, "windowed scatter-mean")
    return scatter_mean_plain(features, knn_idx, num_fine)[0].to(features.dtype)
