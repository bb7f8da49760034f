"""Host-to-device input pipeline: shuffled batches, a prefetching thread and
the data-parallel shards.

Counterpart of ``mpa_tpu/data/pipeline.py``. A background thread builds the
host batches (the iteration, the transform, and pinning each array) while
the card runs the previous step; the consumer issues every device copy,
``non_blocking`` from pinned memory, so the copies queue on the current
stream behind the running step. That keeps ``mpa_tpu``'s threading
contract (``pipeline.py:55-64``): the producer does host work only. An
exception in the producer reaches the consumer and is raised there; it does
not pose as the end of the data. The producer's spans are
``pipeline.transform`` and ``pipeline.pin``, the consumer's
``pipeline.wait`` (which counts the waits, and those that found the queue
empty, in ``profiling.COUNTS``) and ``pipeline.copy``; each takes the
batch's index as its unit.

Data parallelism: every rank iterates the same shuffled global batches (the
same seed) and keeps its own rows (:func:`host_shard`);
:func:`global_batch_from_local` gathers the ranks' shares again.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mpa_tpu_torch.utils.profiling import COUNTS, span


def batch_iterator(
    arrays: Sequence[np.ndarray],
    batch_size: int,
    *,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Co-indexed batches of ``arrays``, shuffled by ``rng.permutation`` (in
    order when ``rng`` is None); ``drop_last`` drops the ragged tail."""
    n = len(arrays[0])
    order = rng.permutation(n) if rng is not None else np.arange(n)
    stop = n - n % batch_size if drop_last else n
    for i in range(0, stop, batch_size):
        idx = order[i : i + batch_size]
        yield tuple(a[idx] for a in arrays)


def _map(fn: Callable[[Any], Any], item: Any) -> Any:
    """``fn`` over the leaves of nested tuples and lists."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, x) for x in item)
    return fn(item)


def prefetch_to_device(
    iterator: Iterator[Any],
    device: torch.device,
    buffer_size: int = 2,
    transform: Optional[Callable[[Any], Any]] = None,
) -> Iterator[Any]:
    """Yield the items of ``iterator`` (after ``transform``) as tensors on
    ``device``, up to ``buffer_size`` items built ahead on a background
    thread. Items are numpy arrays or tensors, or nested tuples and lists of
    them. For a CUDA device the producer pins each array and the consumer
    copies it with ``non_blocking=True``. Closing the generator early stops
    the producer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    end = object()

    def host(x):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if pin else t

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for i, item in enumerate(iterator):
                if transform is not None:
                    with span("pipeline.transform", i):
                        item = transform(item)
                with span("pipeline.pin", i):
                    item = _map(host, item)
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # the consumer raises it; it is not the end
            put(e)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
    thread.start()
    try:
        for i in itertools.count():
            with span("pipeline.wait", i):
                COUNTS["input_waits"] += 1
                if q.empty():
                    COUNTS["input_empty"] += 1
                item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            with span("pipeline.copy", i):
                item = _map(lambda t: t.to(device, non_blocking=True), item)
            yield item
    finally:
        stop.set()
        thread.join(timeout=10.0)


def host_shard(arrays: Sequence[np.ndarray], global_batch: int, rank: Optional[int] = None,
               world_size: Optional[int] = None) -> Tuple[np.ndarray, ...]:
    """Rank ``r`` of ``P`` keeps rows ``[r*B/P, (r+1)*B/P)`` of each array of a
    global batch of ``B`` rows; rank and size default to the default process
    group's (``(0, 1)`` without one). ``B`` must divide by ``P``."""
    if rank is None or world_size is None:
        group = dist.is_available() and dist.is_initialized()
        rank = dist.get_rank() if group else 0
        world_size = dist.get_world_size() if group else 1
    if global_batch % world_size:
        raise ValueError(f"a global batch of {global_batch} does not split over "
                         f"{world_size} ranks")
    local = global_batch // world_size
    return tuple(a[rank * local : (rank + 1) * local] for a in arrays)


def global_batch_from_local(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's equal share of a batch, concatenated in rank order, on
    every rank of ``group`` (default: the world): one all-reduce of a
    zero-padded buffer, which ``gloo`` serves on a card too."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    out = local.new_zeros((size * local.shape[0],) + tuple(local.shape[1:]))
    out[rank * local.shape[0] : (rank + 1) * local.shape[0]] = local
    dist.all_reduce(out, group=group)
    return out
