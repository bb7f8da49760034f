"""Port parity, the input pipeline, on the CPU.

``mpa_tpu_torch.data.pipeline`` against ``mpa_tpu.data.pipeline``: the
shuffled batches of one seed, the data-parallel shards for 1, 2 and 4
ranks, and ``prefetch_to_device``'s contract: every batch, in order, with
its transform; a producer's error raised in the consumer, not taken for the
end of the data; an early stop that ends the producer.
"""

import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_cls  # noqa: E402,F401  (one torch thread)

from mpa_tpu.data import pipeline as jax_pipeline  # noqa: E402
from mpa_tpu_torch.data import pipeline  # noqa: E402


def _arrays(n=23):
    rng = np.random.default_rng(0)
    return rng.standard_normal((n, 5, 3)).astype(np.float32), rng.integers(0, 9, n)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("seed", [None, 0, 7])
def test_batch_iterator_equals_mpa_tpu(seed, drop_last):
    arrays = _arrays()
    rng = lambda: None if seed is None else np.random.default_rng(seed)  # noqa: E731
    got = list(pipeline.batch_iterator(arrays, 4, rng=rng(), drop_last=drop_last))
    want = list(jax_pipeline.batch_iterator(arrays, 4, rng=rng(), drop_last=drop_last))
    assert len(got) == len(want) == (5 if drop_last else 6)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_host_shard_equals_mpa_tpu(ranks, monkeypatch):
    arrays = _arrays(8)
    monkeypatch.setattr(jax, "process_count", lambda: ranks)
    for rank in range(ranks):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        want = jax_pipeline.host_shard(arrays, 8)
        got = pipeline.host_shard(arrays, 8, rank, ranks)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="split"):
        pipeline.host_shard(arrays, 6, 0, 4)
    assert all(np.array_equal(a, b) for a, b in zip(pipeline.host_shard(arrays, 8), arrays))


def test_prefetch_yields_every_batch_in_order():
    arrays = _arrays(40)
    batches = list(pipeline.batch_iterator(arrays, 4, rng=np.random.default_rng(3)))
    seen = []

    def transform(batch):
        seen.append(threading.current_thread().name)
        x, y = batch
        return (x * 2.0, (y, y + 1))

    out = list(pipeline.prefetch_to_device(iter(batches), torch.device("cpu"), buffer_size=2,
                                           transform=transform))
    assert len(out) == len(batches) == 10
    for (x, (y, y1)), (bx, by) in zip(out, batches):
        assert torch.is_tensor(x) and torch.is_tensor(y)
        np.testing.assert_array_equal(x.numpy(), bx * 2.0)
        np.testing.assert_array_equal(y.numpy(), by)
        np.testing.assert_array_equal(y1.numpy(), by + 1)
    assert set(seen) == {"prefetch_to_device"}  # the host work ran on the producer


def test_prefetch_reraises_a_producer_error():
    def broken():
        yield (np.zeros(3),)
        yield (np.ones(3),)
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for (x,) in pipeline.prefetch_to_device(broken(), "cpu"):
            got.append(x)
    assert len(got) == 2  # what came before the error arrived, then the error

    def bad_transform(batch):
        raise ValueError("bad batch")

    with pytest.raises(ValueError, match="bad batch"):
        list(pipeline.prefetch_to_device(iter([(np.zeros(2),)]), "cpu",
                                         transform=bad_transform))


def test_prefetch_stops_its_producer_when_closed_early():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield (np.full(2, i),)
            i += 1

    before = threading.active_count()
    feed = pipeline.prefetch_to_device(endless(), "cpu", buffer_size=2)
    assert [int(next(feed)[0][0]) for _ in range(3)] == [0, 1, 2]
    feed.close()
    assert threading.active_count() == before
    assert len(produced) <= 3 + 2 + 2  # at most the buffer ran ahead
