"""Depth regulariser: the CUDA kernel ``csrc/regularize.cu``, its plain
PyTorch version, and the wrapper that picks one by device.

Replaces ``dvo_tpu/ops/pallas/regularize.py:_regularize_kernel`` (via
``regularize_pallas``); both versions follow the XLA twin
``dvo_tpu.models.mapper.regularize``.  The kernel's header note says what
bounds it on the card, which launches were measured and why ``LAUNCH`` was
kept.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import MapperConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.depth_filter import gaussian_fuse


# Per pixel: depth and sigma read, depth written; each of the four
# neighbours costs the gate (8 float operations) and the fusion (10), and
# the clamp one more.
BYTES_PER_PIXEL = 3 * 4
FLOPS_PER_PIXEL = 4 * 18 + 1


# The kernel's launch (``csrc/regularize.cu``'s ``kLaunch``, whose C entries
# ``dvo_regularize_kind``/``_block_rows``/``_thread_rows`` give it on the
# card): (kind, rows of a block, rows a thread walks).  "flat": one pixel a
# thread on a 1-D grid of 256; "tile": blocks of 32 x rows threads, one
# pixel a thread; "walk": blocks of 32 x rows threads, a warp 32
# neighbouring columns, a thread ``thread_rows`` rows of its column, left
# and right neighbours from the neighbouring lanes.
KINDS = ("flat", "tile", "walk")
FLAT_THREADS = 256
LAUNCH = ("tile", 4, 1)


def launch_grid(h: int, w: int, launch=LAUNCH):
    """(grid, block) of a launch at h x w pixels, CUDA's (x, y) order."""
    kind, block_rows, thread_rows = launch
    if kind == "flat":
        return (-(-h * w // FLAT_THREADS), 1), (FLAT_THREADS, 1)
    rows = block_rows * (thread_rows if kind == "walk" else 1)
    return (-(-w // 32), -(-h // rows)), (32, block_rows)


def work(shape):
    """(bytes, float operations) of one call at ``shape`` = (h, w)."""
    n = shape[0] * shape[1]
    return BYTES_PER_PIXEL * n, FLOPS_PER_PIXEL * n


def _neighbour(img: torch.Tensor, dx: int, dy: int, fill: float):
    """(value of the neighbour at (x + dx, y + dy), in-bounds mask)."""
    h, w = img.shape
    out = torch.full_like(img, fill)
    ok = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    ys0, ys1 = max(-dy, 0), h + min(-dy, 0)
    xs0, xs1 = max(-dx, 0), w + min(-dx, 0)
    out[ys0:ys1, xs0:xs1] = img[ys0 + dy:ys1 + dy, xs0 + dx:xs1 + dx]
    ok[ys0:ys1, xs0:xs1].fill_(True)
    return out, ok


def regularize_plain(depth, sigma, cfg: MapperConfig = MapperConfig()):
    """Fuse left, right, down, up neighbours (implement.cpp:160 order) from
    the original maps; clamp to ``max_depth``.  Depth only."""
    mu, sg = depth, sigma
    for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
        nd, ok = _neighbour(depth, dx, dy, 0.0)
        ns, _ = _neighbour(sigma, dx, dy, 1.0)
        mu, sg, _ = gaussian_fuse(mu, sg, nd, ns, obs_valid=ok, cfg=cfg.depth_filter)
    return torch.clamp(mu, max=cfg.max_depth)


def regularize(depth, sigma, cfg: MapperConfig = MapperConfig()):
    """``regularize_plain`` for CPU tensors; the ``csrc/regularize.cu``
    kernel for CUDA tensors (it launches or raises)."""
    if resolve_device(depth) == "plain":
        return regularize_plain(depth, sigma, cfg)
    h, w = depth.shape
    dev = depth.device
    _build.require(depth, "depth", torch.float32, (h, w), dev)
    _build.require(sigma, "sigma", torch.float32, (h, w), dev)
    out = torch.empty_like(depth)
    code = _build.library().dvo_regularize(
        depth.data_ptr(), sigma.data_ptr(), out.data_ptr(), h, w,
        cfg.depth_filter.gain_ramp, cfg.max_depth, _build.stream_handle(dev),
    )
    _build.check(code, "regularize")
    _build.LAUNCHES["regularize"] += 1
    return out
