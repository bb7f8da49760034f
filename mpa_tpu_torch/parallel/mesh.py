"""Data parallelism over a ``torch.distributed`` process group.

Counterpart of ``mpa_tpu/parallel/mesh.py``. There one ``jit`` holds the
whole sharded batch, so XLA derives the gradient all-reduce and BatchNorm's
global-batch statistics itself. Here every rank is a process that runs the
model on its share of the global batch, and the port says where the ranks
meet:

- :func:`init` joins the process group from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
  or from explicit arguments;
- :func:`shard_batch` moves this rank's rows of a global host batch to the
  rank's device (``data/pipeline.py::host_shard`` slices them);
- :func:`replicate` broadcasts rank 0's parameters and buffers;
- :func:`sync_batchnorm` gives every ``BatchNorm`` of a model the group, so
  its train-mode statistics are the global batch's (``nn/linear.py``);
- :func:`make_data_parallel_train_step` is ``TRAIN_STEPS[task]`` with the
  gradients, and the reported loss, averaged over the ranks in one
  all-reduce before the optimizer;
- ``data/pipeline.py::global_batch_from_local`` gathers the ranks' shares.

The all-reduces run on whatever backend the group has: ``nccl`` between
cards, ``gloo`` on the CPU (and between processes that share one card, which
NCCL refuses). Nothing here runs without a group: a single process has no
collective at all.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from mpa_tpu_torch.configs import TrainConfig
from mpa_tpu_torch.data.pipeline import host_shard
from mpa_tpu_torch.nn.linear import BatchNorm
from mpa_tpu_torch.train.loop import TRAIN_STEPS

Group = Optional[dist.ProcessGroup]


def init(backend: Optional[str] = None, *, device: Optional[torch.device] = None,
         init_method: Optional[str] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None, timeout_s: float = 600.0) -> torch.device:
    """Join the default process group and return this rank's device.

    Rank and world size come from the arguments or from torchrun's ``RANK``
    and ``WORLD_SIZE``; the rendezvous from ``init_method`` or from
    ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). ``device`` defaults to
    ``cuda:LOCAL_RANK``; ``backend`` to ``nccl`` on a CUDA device and
    ``gloo`` on the CPU."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s))
    return device


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_batch(batch: Tuple[np.ndarray, ...], device: torch.device,
                rank: Optional[int] = None, world_size: Optional[int] = None
                ) -> Tuple[torch.Tensor, ...]:
    """This rank's rows ``[r*B/P, (r+1)*B/P)`` of each array of a global
    host batch, as tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in host_shard(batch, len(batch[0]), rank, world_size))


@torch.no_grad()
def replicate(module: nn.Module, group: Group = None) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=group)
    return module


def sync_batchnorm(module: nn.Module, group: Any = None) -> nn.Module:
    """Give every ``BatchNorm`` of ``module`` the process ``group`` (default:
    the world), in place; ``group=False`` takes it away again."""
    if group is None:
        group = dist.group.WORLD
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.process_group = None if group is False else group
    return module


def average_gradients(params: List[torch.Tensor], loss: torch.Tensor,
                      group: Group = None) -> torch.Tensor:
    """Replace each gradient by its mean over the ranks, and return the mean
    loss, with one all-reduce of one flat buffer."""
    size = dist.get_world_size(group)
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
    dist.all_reduce(flat, group=group)
    flat /= size
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n
    return flat[-1]


def make_data_parallel_train_step(cfg: TrainConfig, steps_per_epoch: int, group: Group = None):
    """``TRAIN_STEPS[cfg.task]`` run by every rank on its shard: its
    gradients and loss averaged over the ranks before the optimizer (give
    the model :func:`sync_batchnorm` and :func:`replicate` first). The loss
    it returns is the global batch's."""
    return TRAIN_STEPS[cfg.task](
        cfg, steps_per_epoch,
        reduce_grads=lambda params, loss: average_gradients(params, loss, group))

