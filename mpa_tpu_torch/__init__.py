"""mpa_tpu_torch — the PyTorch / CUDA port of ``mpa_tpu`` for NVIDIA Hopper.

Mirrors ``mpa_tpu``'s module layout so each module's counterpart is easy to
find:

- point-set primitives (kNN, FPS, row gather, transition attention,
  scatter-mean upsample), each a plain PyTorch version plus hand-written
  CUDA kernels, forward and backward                         -> mpa_tpu_torch.ops
- the kernels' CUDA C++ sources and their build              -> mpa_tpu_torch.kernels
- Markov transition blocks                                   -> mpa_tpu_torch.nn
- task models                                                -> mpa_tpu_torch.models
- inference entry points                                     -> mpa_tpu_torch.serve
- losses, schedules, train / eval steps, metrics             -> mpa_tpu_torch.train
- datasets, augmentations, the prefetching input pipeline    -> mpa_tpu_torch.data
- data parallelism (process group, cross-replica BatchNorm)  -> mpa_tpu_torch.parallel
- the training config, its flags, presets                    -> mpa_tpu_torch.configs
- seeding and --init, logging, profiling, reference import   -> mpa_tpu_torch.utils
- training and eval CLIs                                     -> mpa_tpu_torch.cli

Conventions, as in ``mpa_tpu``: channel-last ``[B, N, C]`` tensors and int32
indices at every public function. Entry points run on ``cuda`` unless the
caller asks for ``device="cpu"``; a CUDA request without a card raises.
On a CPU tensor every op takes its plain PyTorch version; on a CUDA tensor it
launches its kernel.

This package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"
