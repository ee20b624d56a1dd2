"""Depth regulariser: the CUDA kernel ``csrc/regularize.cu``, its plain
PyTorch version, and the wrapper that picks one by device.

Replaces ``dvo_tpu/ops/pallas/regularize.py:_regularize_kernel`` (via
``regularize_pallas``); both versions follow the XLA twin
``dvo_tpu.models.mapper.regularize``.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import MapperConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.depth_filter import gaussian_fuse


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
