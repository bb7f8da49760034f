"""Point-set primitives, channel-last ``[B, N, C]``, int32 indices.

Each op with a kernel has a plain PyTorch version (taken for CPU tensors, and
the reference its kernel is held against) and a CUDA wrapper (taken for CUDA
tensors; it launches the kernel or raises).
"""

from mpa_tpu_torch.ops.pairwise import square_distance
from mpa_tpu_torch.ops.knn import knn
from mpa_tpu_torch.ops.fps import (
    banded_farthest_point_sample,
    farthest_point_sample,
    pick_fps_bands,
)
from mpa_tpu_torch.ops.gather import index_points, resort_points
from mpa_tpu_torch.ops.ball_query import ball_query
from mpa_tpu_torch.ops.attention import transition_attention
from mpa_tpu_torch.ops.scatter import scatter_mean_upsample
from mpa_tpu_torch.ops.interp import three_nn_interpolate
from mpa_tpu_torch.ops.morton import morton_code, morton_order
from mpa_tpu_torch.ops.sampling import subsample_points
from mpa_tpu_torch.ops.window import (
    WindowSpec,
    make_window_spec,
    windowed_knn_with_spec,
    windowed_scatter_mean,
    windowed_transition_attention,
)

__all__ = [
    "square_distance",
    "knn",
    "farthest_point_sample",
    "index_points",
    "resort_points",
    "ball_query",
    "transition_attention",
    "scatter_mean_upsample",
    "three_nn_interpolate",
    "banded_farthest_point_sample",
    "pick_fps_bands",
    "morton_code",
    "morton_order",
    "subsample_points",
    "WindowSpec",
    "make_window_spec",
    "windowed_knn_with_spec",
    "windowed_transition_attention",
    "windowed_scatter_mean",
]
