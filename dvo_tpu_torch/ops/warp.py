"""Pinhole geometry and dense inverse warping — ``dvo_tpu.ops.warp`` ported
(reference transform.cpp:20-51)."""

from __future__ import annotations

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import EPSILON
from dvo_tpu_torch.ops.sampling import bilinear_masked


def pixel_grid(h: int, w: int, device=None, dtype=torch.float32):
    """(x, y) coordinate images of shape (H, W)."""
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device, dtype=dtype),
        torch.arange(w, device=device, dtype=dtype),
        indexing="ij",
    )
    return xs, ys


def project(K: torch.Tensor, pts: torch.Tensor):
    """(..., 3) camera points -> ((..., 2) pixels, in_front)."""
    z = pts[..., 2]
    safe_z = torch.where(torch.abs(z) < EPSILON, 1.0, z)
    u = pts[..., 0] * K[0, 0] / safe_z + K[0, 2]
    v = pts[..., 1] * K[1, 1] / safe_z + K[1, 2]
    return torch.stack([u, v], dim=-1), z > EPSILON


def back_project(K: torch.Tensor, xy: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(..., 2) pixels + (...) depth -> (..., 3) camera points."""
    x = depth * (xy[..., 0] - K[0, 2]) / K[0, 0]
    y = depth * (xy[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y, depth], dim=-1)


def warp_points(T: torch.Tensor, xy: torch.Tensor, depth: torch.Tensor, K: torch.Tensor):
    """project(K, T @ back_project(K, xy, depth))."""
    return project(K, lie.transform(T, back_project(K, xy, depth)))


def warp_image(xi, gray, gray_mask, depth, K):
    """Dense inverse warp (transform.cpp:35-51): each output pixel with
    usable depth samples ``gray`` where ``exp(-xi)`` sends it.
    Returns (warped, warped_mask)."""
    h, w = gray.shape
    xs, ys = pixel_grid(h, w, device=gray.device)
    xy = torch.stack([xs, ys], dim=-1)
    warped_xy, in_front = warp_points(lie.se3_exp(-xi), xy, depth, K)
    vals, valid = bilinear_masked(gray, gray_mask, warped_xy[..., 0], warped_xy[..., 1])
    mask = (torch.abs(depth) >= EPSILON) & valid & in_front
    return torch.where(mask, vals, 0.0), mask


def map_depth_to_gray(depth, gray, gray_mask, rgb_K, depth_K, inv_T,
                      sigma_valid: float = 0.1, sigma_invalid: float = 1.0):
    """Register the color camera's gray into the depth camera's frame
    (transform.cpp:53-78): back-project each depth pixel with ``depth_K``,
    move it by ``inv_T``, project with ``rgb_K`` and sample ``gray``; sigma
    is ``sigma_valid`` where a valid sample landed, ``sigma_invalid``
    elsewhere.  ``depth`` (H, W) with ``gray`` (Hg, Wg), or a chunk:
    ``depth`` (N, H, W) with ``gray`` (N, Hg, Wg) and ``gray_mask`` (Hg, Wg)
    or (N, Hg, Wg).  Returns (mapped_gray, mapped_mask, sigma)."""
    h, w = depth.shape[-2:]
    xs, ys = pixel_grid(h, w, device=depth.device)
    xy = torch.stack([xs, ys], dim=-1)
    pts = lie.transform(inv_T, back_project(depth_K, xy, depth))
    warped_xy, in_front = project(rgb_K, pts)
    vals, valid = bilinear_masked(gray, gray_mask, warped_xy[..., 0], warped_xy[..., 1])
    mask = (torch.abs(depth) >= EPSILON) & valid & in_front
    sigma = torch.where(mask, sigma_valid, sigma_invalid).to(torch.float32)
    return torch.where(mask, vals, 0.0), mask, sigma
