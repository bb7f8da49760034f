"""Device resolution: ``cuda`` unless the caller asks otherwise, never a
silent fall-back to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the ``torch.device`` an entry point runs on.

    ``None`` means ``cuda``. A CUDA device without a usable card raises
    ``RuntimeError``. On a CUDA device the float32 matmul and convolution
    paths are pinned to full float32 (no TF32): the port is held to the JAX
    reference in float32, and kNN selection reads the low bits of distances.
    bf16 matmuls (the mixed precision models') are pinned to float32
    accumulation (no reduced-precision reduction inside cuBLAS), as XLA
    accumulates a bf16 dot in float32; the setting touches no float32 path.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch ops"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(t: torch.Tensor, name: Optional[str] = None) -> bool:
    """True when ``t`` lies on a CUDA device, False on the CPU; raises for any
    other device so no op silently takes its plain version there."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name or 'tensor'} on unsupported device {t.device}")
