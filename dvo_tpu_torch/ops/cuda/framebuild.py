"""Fused frame build: the CUDA kernel ``csrc/framebuild.cu``, its plain
PyTorch version, and the wrappers that pick one by device.

Replaces ``dvo_tpu/ops/pallas/framebuild.py:_build_kernel`` (via
``_pyramid_call``) with the same three entry points, names and return
structures: ``build_pyramid_planes``, ``cull_pyramid_one`` and
``cull_pyramid_pair``.  The plain versions are the XLA build they stand
for, ``ops.image.cull_image`` per level plus ``gradients``; the kernel is
bit-identical to them (every output is a copy or one subtraction).

``regularize_cull_pyramid`` is the cull as the epilogue of the depth
regulariser: one launch of ``regularize_cull_kernel`` (same source) where
the monocular mapper ran the pair build, ``csrc/regularize.cu`` and the
one-plane build; its plain version is ``regularize_plain`` followed by the
pair's.

The kernel writes each plane kind into one buffer holding all levels back
to back, and the wrappers return per-level views of it: contiguous views at
an offset, which the other kernels take as they are.  Nothing in the port
writes into a pyramid plane, so the aliasing is never visible.  A launch
takes 1 to ``MAX_LEVELS`` levels: a block's tile is 2**(levels - 1) base
rows tall (``csrc/framebuild_cull.cuh``).
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import MapperConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.cuda import regularize as _regularize
from dvo_tpu_torch.ops.image import cull_image, gradients

MAX_VALUES = 3  # value planes one launch carries (gray, depth, sigma)
MAX_LEVELS = 6  # csrc/framebuild_cull.cuh kMaxLevels


def _levels(levels: int):
    """Decimation exponents t, coarsest level first (frame.cpp:30-37)."""
    return range(levels - 1, -1, -1)


def _size(h0: int, w0: int, t: int):
    """Output size of a 2**t point-sample decimation: ceil(n / 2**t)."""
    r = 2 ** t
    return -(-h0 // r), -(-w0 // r)


def work(shape, levels: int, n_values: int, with_mask: bool):
    """(bytes, float operations) of one launch on a base (h0, w0) frame:
    ``n_values`` float32 planes (and the mask) read once, every level of
    every output plane written once (with a mask: mask, gx, gy, gmask, two
    subtractions per pixel); without a mask nothing is computed."""
    h0, w0 = shape
    total = sum(h * w for h, w in (_size(h0, w0, t) for t in _levels(levels)))
    nbytes = 4 * n_values * (h0 * w0 + total)
    if with_mask:
        nbytes += h0 * w0 + (1 + 4 + 4 + 1) * total
    return nbytes, 2 * total if with_mask else 0


def work_regularize_cull(shape, levels: int):
    """(bytes, float operations) of one regularize-and-cull launch on a base
    (h0, w0) map: depth and sigma read once, every level of both written
    once; the regulariser's operations per base pixel."""
    h0, w0 = shape
    total = sum(h * w for h, w in (_size(h0, w0, t) for t in _levels(levels)))
    return 4 * 2 * (h0 * w0 + total), _regularize.FLOPS_PER_PIXEL * h0 * w0


# ------------------------------------------------------------ plain versions

def build_pyramid_planes_plain(gray, mask, depth, sigma, levels: int):
    """Per-level dicts, coarsest first, with keys gray/depth/sigma/mask/gx/
    gy/gmask.  ``depth`` and ``sigma`` may both be None (a tracking frame),
    and then are None at every level."""
    out = []
    for t in _levels(levels):
        g, m = cull_image(gray, t), cull_image(mask, t)
        gx, gy, mx, my = gradients(g, m)
        out.append(dict(
            gray=g,
            depth=None if depth is None else cull_image(depth, t),
            sigma=None if sigma is None else cull_image(sigma, t),
            mask=m, gx=gx, gy=gy, gmask=mx & my,
        ))
    return out


def cull_pyramid_one_plain(plane, levels: int):
    return [cull_image(plane, t) for t in _levels(levels)]


def cull_pyramid_pair_plain(depth, sigma, levels: int):
    return [(cull_image(depth, t), cull_image(sigma, t)) for t in _levels(levels)]


def regularize_cull_pyramid_plain(depth, sigma, levels: int,
                                  cfg: MapperConfig = MapperConfig()):
    return cull_pyramid_pair_plain(_regularize.regularize_plain(depth, sigma, cfg), sigma,
                                   levels)


# ------------------------------------------------------------------- kernel

def _check_levels(levels: int) -> None:
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels={levels}; the kernel takes 1 to {MAX_LEVELS}")


def _split(buf, sizes):
    """Per-level (h, w) views of one plane kind's buffer."""
    views, off = [], 0
    for h, w in sizes:
        views.append(buf[off:off + h * w].view(h, w))
        off += h * w
    return views


def _launch(values, mask, levels: int):
    """One launch over every level.  Returns (per value plane a list of
    per-level views, and for the mask variant the lists of mask, gx, gy and
    gmask views, else None)."""
    if not 1 <= len(values) <= MAX_VALUES:
        raise ValueError(f"{len(values)} value planes; the kernel takes 1 to {MAX_VALUES}")
    _check_levels(levels)
    h0, w0 = values[0].shape
    dev = values[0].device
    for k, v in enumerate(values):
        _build.require(v, f"value plane {k}", torch.float32, (h0, w0), dev)
    if mask is not None:
        _build.require(mask, "mask", torch.bool, (h0, w0), dev)

    sizes = [_size(h0, w0, t) for t in _levels(levels)]
    total = sum(h * w for h, w in sizes)
    vals = torch.empty((len(values), total), dtype=torch.float32, device=dev)
    grads = None
    if mask is not None:
        grads = (torch.empty(total, dtype=torch.bool, device=dev),
                 torch.empty(total, dtype=torch.float32, device=dev),
                 torch.empty(total, dtype=torch.float32, device=dev),
                 torch.empty(total, dtype=torch.bool, device=dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    ins = list(values) + [None] * (MAX_VALUES - len(values))
    m_out, gx, gy, gm = grads if grads is not None else (None,) * 4
    code = _build.library().dvo_framebuild(
        ptr(ins[0]), ptr(ins[1]), ptr(ins[2]), ptr(mask), vals.data_ptr(),
        ptr(m_out), ptr(gx), ptr(gy), ptr(gm), h0, w0, levels, len(values), total,
        _build.stream_handle(dev),
    )
    _build.check(code, "framebuild")
    _build.LAUNCHES["framebuild"] += 1

    return ([_split(v, sizes) for v in vals],
            None if grads is None else [_split(b, sizes) for b in grads])


# ----------------------------------------------------------------- wrappers

def build_pyramid_planes(gray, mask, depth, sigma, levels: int):
    """All pyramid planes of a base-level (H0, W0) frame: gray f32 in
    [0, 1], mask bool, depth/sigma f32 (or both None).  The plain version
    for CPU tensors; one ``csrc/framebuild.cu`` launch for CUDA tensors (it
    launches or raises)."""
    if (depth is None) != (sigma is None):
        raise ValueError("depth and sigma must both be given or both be None")
    if resolve_device(gray) == "plain":
        return build_pyramid_planes_plain(gray, mask, depth, sigma, levels)
    values = [gray] if depth is None else [gray, depth, sigma]
    planes, (masks, gxs, gys, gmasks) = _launch(values, mask, levels)
    return [
        dict(gray=planes[0][i],
             depth=None if depth is None else planes[1][i],
             sigma=None if sigma is None else planes[2][i],
             mask=masks[i], gx=gxs[i], gy=gys[i], gmask=gmasks[i])
        for i in range(levels)
    ]


def cull_pyramid_one(plane, levels: int):
    """One plane's pyramid, coarsest first (``with_depth`` with sigma
    kept)."""
    if resolve_device(plane) == "plain":
        return cull_pyramid_one_plain(plane, levels)
    return _launch([plane], None, levels)[0][0]


def cull_pyramid_pair(depth, sigma, levels: int):
    """Depth/sigma pyramid as a list of (depth_t, sigma_t), coarsest first
    (reference Frame::updateDepthSigma, frame.cpp:39-61)."""
    if resolve_device(depth) == "plain":
        return cull_pyramid_pair_plain(depth, sigma, levels)
    (ds, ss), _ = _launch([depth, sigma], None, levels)
    return list(zip(ds, ss))


def regularize_cull_pyramid(depth, sigma, levels: int, cfg: MapperConfig = MapperConfig()):
    """The pyramid of the regularised depth and of the unchanged sigma, as a
    list of (depth_t, sigma_t), coarsest first: ``regularize`` then
    ``cull_pyramid_pair`` in one launch for CUDA tensors (it launches or
    raises), the plain version for CPU tensors."""
    if resolve_device(depth) == "plain":
        return regularize_cull_pyramid_plain(depth, sigma, levels, cfg)
    _check_levels(levels)
    h0, w0 = depth.shape
    dev = depth.device
    _build.require(depth, "depth", torch.float32, (h0, w0), dev)
    _build.require(sigma, "sigma", torch.float32, (h0, w0), dev)
    sizes = [_size(h0, w0, t) for t in _levels(levels)]
    total = sum(h * w for h, w in sizes)
    vals = torch.empty((2, total), dtype=torch.float32, device=dev)
    code = _build.library().dvo_regularize_cull(
        depth.data_ptr(), sigma.data_ptr(), vals.data_ptr(), h0, w0, levels, total,
        cfg.depth_filter.gain_ramp, cfg.max_depth, _build.stream_handle(dev),
    )
    _build.check(code, "regularize_cull")
    _build.LAUNCHES["regularize_cull"] += 1
    return list(zip(_split(vals[0], sizes), _split(vals[1], sizes)))
