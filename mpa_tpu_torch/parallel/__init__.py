"""Data parallelism (counterpart of ``mpa_tpu/parallel``): one process a
rank, the global batch sharded over the ranks, BatchNorm's statistics and
the gradients reduced over the process group (``mesh.py``)."""

from mpa_tpu_torch.data.pipeline import global_batch_from_local, host_shard
from mpa_tpu_torch.parallel.mesh import (
    average_gradients,
    init,
    make_data_parallel_train_step,
    replicate,
    shard_batch,
    sync_batchnorm,
    world,
)

__all__ = ["average_gradients", "global_batch_from_local", "host_shard", "init",
           "make_data_parallel_train_step", "replicate", "shard_batch", "sync_batchnorm",
           "world"]
