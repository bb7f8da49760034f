"""Hand-written Hopper kernels of the port and their launch counts.

The CUDA C++ sources live in ``csrc/``; ``build.py`` compiles them at first
use. Each kernel's entry, a custom op's CUDA implementation in
``mpa_tpu_torch.ops`` (``ops/library.py``), calls :func:`launched` right
where it launches its kernel, and nowhere else (not in the op's fake, which
a trace calls), so a run can show that its path went through the kernels,
eager or exported: reset the counts, drive the path, read them.
The backward kernels (``scatter_add_rows_kernel``,
``transition_attention_bwd_kernel``, ``windowed_attention_bwd_kernel``) are
launched from the ``backward`` of their ops' ``torch.autograd.Function`` and
are counted and recorded there; the scatter-means' backward launches
``gather_rows_kernel``. The ``windowed_*`` kernels serve the Morton-window
modes (``ops/window.py``); ``ball_query_kernel`` the set abstraction of
``repsurf_ssg_2x`` (``ops/ball_query.py``).

``NORM_KERNELS``, the fused train-mode BatchNorm + LeakyReLU forward and
backward (``ops/batch_norm.py``, three device kernels each), count each call
in ``NORM_LAUNCHES`` through :func:`norm_launched` and are never recorded:
replaying a launch and bounding its work is what a recording is for, and
neither ``chip_smoke.py``'s replays nor the benchmark's bound know them.

Eight kernels also take bf16 storage, the mixed precision models'
(``compute_dtype=torch.bfloat16``): ``BF16_KERNELS``, the five of the
exact path and the three windowed ones that ``markov_partseg``'s window
modes run in bf16. ``LAUNCHES`` counts
every launch of a kernel, whatever its storage; ``LAUNCHES_BF16`` counts
the bf16 ones among them, so a path's float32 launches are the difference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

KERNELS = (
    "knn_kernel",
    "fps_kernel",
    "gather_rows_kernel",
    "transition_attention_fwd_kernel",
    "scatter_add_rows_kernel",
    "transition_attention_bwd_kernel",
    "scatter_mean_kernel",
    "windowed_knn_kernel",
    "windowed_attention_fwd_kernel",
    "windowed_attention_bwd_kernel",
    "windowed_scatter_mean_kernel",
    "ball_query_kernel",
)

NORM_KERNELS = ("batch_norm_act_kernel", "batch_norm_act_bwd_kernel")

BF16_KERNELS = (
    "gather_rows_kernel",
    "transition_attention_fwd_kernel",
    "scatter_add_rows_kernel",
    "transition_attention_bwd_kernel",
    "scatter_mean_kernel",
    "windowed_attention_fwd_kernel",
    "windowed_attention_bwd_kernel",
    "windowed_scatter_mean_kernel",
)

# Each kernel's CUDA source, under ``csrc/``.
SOURCES: Dict[str, str] = {
    name: f"mpa_tpu_torch/kernels/csrc/{src}" for name, src in (
        ("knn_kernel", "knn.cu"), ("fps_kernel", "fps.cu"), ("gather_rows_kernel", "gather.cu"),
        ("transition_attention_fwd_kernel", "attention.cu"),
        ("scatter_add_rows_kernel", "scatter_add.cu"),
        ("transition_attention_bwd_kernel", "attention_bwd.cu"),
        ("scatter_mean_kernel", "scatter_mean.cu"), ("windowed_knn_kernel", "window_knn.cu"),
        ("windowed_attention_fwd_kernel", "window_attention.cu"),
        ("windowed_attention_bwd_kernel", "window_attention_bwd.cu"),
        ("windowed_scatter_mean_kernel", "window_scatter_mean.cu"),
        ("ball_query_kernel", "ball_query.cu"))}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
LAUNCHES_BF16: Dict[str, int] = {name: 0 for name in BF16_KERNELS}
NORM_LAUNCHES: Dict[str, int] = {name: 0 for name in NORM_KERNELS}

# When a list, every launch also appends ``(name, inputs)`` to it, so a
# measurement can replay each kernel on the very inputs its path gave it.
recorded: Optional[List[Tuple[str, dict]]] = None


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for name in BF16_KERNELS:
        LAUNCHES_BF16[name] = 0
    for name in NORM_KERNELS:
        NORM_LAUNCHES[name] = 0


def launched(name: str, inputs: dict, bf16: bool = False) -> None:
    """Count one launch of ``name`` (``bf16``: on bf16 storage) and, while
    recording, keep its inputs."""
    LAUNCHES[name] += 1
    if bf16:
        LAUNCHES_BF16[name] += 1
    if recorded is not None:
        recorded.append((name, inputs))


def norm_launched(name: str) -> None:
    """Count one call of the norm kernel ``name``; nothing is recorded."""
    NORM_LAUNCHES[name] += 1
