"""Pyramid decimation and gradients — ``dvo_tpu.ops.image`` ported.

Point-sampling decimation with no blur (reference convert.cpp:7-29) and
central differences that are NOT halved (convert.cpp:48-73).
"""

from __future__ import annotations

import torch


def cull_image(img: torch.Tensor, times: int) -> torch.Tensor:
    """Decimate (..., H, W) by taking every 2**times-th pixel.  The result
    is contiguous (the kernels take dense planes)."""
    r = 2 ** times
    return img[..., ::r, ::r].contiguous()


# A validity mask follows the same stride (``dvo_tpu.ops.image.cull_mask``).
cull_mask = cull_image


def cull_intrinsic(K: torch.Tensor, times: int) -> torch.Tensor:
    """K / 2**times with K[2, 2] restored to 1."""
    if times == 0:
        return K
    K = K / (2.0 ** times)
    K[..., 2, 2].fill_(1.0)  # fill_, not `= 1.0`: a scalar store syncs on CUDA
    return K


def gradients(gray: torch.Tensor, mask: torch.Tensor):
    """Returns (gx, gy, gmask_x, gmask_y); a gradient pixel is valid iff
    both neighbours are in bounds and valid."""
    gx = torch.zeros_like(gray)
    gy = torch.zeros_like(gray)
    gx[..., :, 1:-1] = gray[..., :, 2:] - gray[..., :, :-2]
    gy[..., 1:-1, :] = gray[..., 2:, :] - gray[..., :-2, :]
    mx = torch.zeros_like(mask)
    my = torch.zeros_like(mask)
    mx[..., :, 1:-1] = mask[..., :, 2:] & mask[..., :, :-2]
    my[..., 1:-1, :] = mask[..., 2:, :] & mask[..., :-2, :]
    return gx, gy, mx, my
