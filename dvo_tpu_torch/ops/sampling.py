"""Sub-pixel bilinear sampling — ``dvo_tpu.ops.sampling`` ported.

Only the exact reference samplers: ``bilinear_dense`` (convert.cpp:77-105,
out-of-range +1 corners fall back to the base corner) and
``bilinear_masked`` (convert.cpp:128-177, invalid corners filled from the
cyclic predecessor).  The TPU's one-hot matrix-unit sampler has no
counterpart here: the GPU gathers natively.

Coordinates are (x, y) pixels; x0 = floor(x) is taken before the integer
cast, as in the JAX package.
"""

from __future__ import annotations

import torch


def corners(x: torch.Tensor, y: torch.Tensor, w: int, h: int):
    """(x0, y0, fx, fy, in0, in_x1, in_y1) of the bilinear footprint."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    in0 = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    in_x1 = x0 + 1 < w
    in_y1 = y0 + 1 < h
    return x0, y0, fx, fy, in0, in_x1, in_y1


def clipped_corners(x0, y0, w: int, h: int):
    """Clamped (x0, x1, y0, y1) corner indices as int64 for indexing."""
    return (
        torch.clamp(x0, 0, w - 1).long(),
        torch.clamp(x0 + 1, 0, w - 1).long(),
        torch.clamp(y0, 0, h - 1).long(),
        torch.clamp(y0 + 1, 0, h - 1).long(),
    )


def _pick(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """``img[yi, xi]``; an (N, H, W) stack is indexed per leading entry of
    the (N, ...) coordinates (the batch axis ``jax.vmap`` would add)."""
    if img.dim() == 2:
        return img[yi, xi]
    b = torch.arange(img.shape[0], device=img.device).view(-1, *([1] * (yi.dim() - 1)))
    return img[b, yi, xi]


def bilinear_dense(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """getSubpixelFromDense semantics.  img: (H, W) or, with (N, ...)
    coordinates, an (N, H, W) stack.  Returns (values, valid) where valid
    is the base corner's in-range flag."""
    h, w = img.shape[-2], img.shape[-1]
    x0, y0, fx, fy, in0, in_x1, in_y1 = corners(x, y, w, h)
    x0c, x1c, y0c, y1c = clipped_corners(x0, y0, w, h)
    g00 = _pick(img, y0c, x0c)
    g10 = torch.where(in_x1, _pick(img, y0c, x1c), g00)
    g01 = torch.where(in_y1, _pick(img, y1c, x0c), g00)
    g11 = torch.where(in_x1 & in_y1, _pick(img, y1c, x1c), g00)
    top = g00 * (1.0 - fx) + g10 * fx
    bot = g01 * (1.0 - fx) + g11 * fx
    return top * (1.0 - fy) + bot * fy, in0


def bilinear_masked(img: torch.Tensor, mask: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """getSubpixel semantics: corners on invalid pixels take the nearest
    valid corner in the cyclic order (x0,y0), (x1,y0), (x0,y1), (x1,y1);
    all four invalid -> invalid sample.  ``img`` and ``mask`` are (H, W)
    or, with (N, ...) coordinates, (N, H, W) stacks.  Returns (values,
    valid)."""
    h, w = img.shape[-2], img.shape[-1]
    x0, y0, fx, fy, in0, in_x1, in_y1 = corners(x, y, w, h)
    x0c, x1c, y0c, y1c = clipped_corners(x0, y0, w, h)

    g00 = _pick(img, y0c, x0c)
    m00 = _pick(mask, y0c, x0c)
    in3 = in_x1 & in_y1
    g = [
        g00,
        torch.where(in_x1, _pick(img, y0c, x1c), g00),
        torch.where(in_y1, _pick(img, y1c, x0c), g00),
        torch.where(in3, _pick(img, y1c, x1c), g00),
    ]
    v = [
        in0 & m00,
        in0 & torch.where(in_x1, _pick(mask, y0c, x1c), m00),
        in0 & torch.where(in_y1, _pick(mask, y1c, x0c), m00),
        in0 & torch.where(in3, _pick(mask, y1c, x1c), m00),
    ]
    g = [torch.where(vi, gi, 0.0) for gi, vi in zip(g, v)]

    # Two sweeps of "if invalid, take the cyclic predecessor" converge.
    for _ in range(2):
        for i in range(4):
            p = (i - 1) % 4
            take = (~v[i]) & v[p]
            g[i] = torch.where(take, g[p], g[i])
            v[i] = v[i] | take

    any_valid = v[0] | v[1] | v[2] | v[3]
    top = g[0] * (1.0 - fx) + g[1] * fx
    bot = g[2] * (1.0 - fx) + g[3] * fx
    return top * (1.0 - fy) + bot * fy, any_valid
