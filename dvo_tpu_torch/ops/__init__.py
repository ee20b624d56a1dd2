"""Image and geometry operators (plain PyTorch) and, under ``ops.cuda``,
the hand-written kernels."""

from dvo_tpu_torch.ops.image import cull_image, cull_mask, cull_intrinsic, gradients
from dvo_tpu_torch.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu_torch.ops.warp import (
    project,
    back_project,
    warp_points,
    warp_image,
    map_depth_to_gray,
)
from dvo_tpu_torch.ops.depth_filter import gaussian_fuse, gaussian_update_with_reset

__all__ = [
    "cull_image",
    "cull_mask",
    "cull_intrinsic",
    "gradients",
    "bilinear_dense",
    "bilinear_masked",
    "project",
    "back_project",
    "warp_points",
    "warp_image",
    "map_depth_to_gray",
    "gaussian_fuse",
    "gaussian_update_with_reset",
]
