"""GN linearisation (one step): the CUDA kernel ``csrc/gn.cu``, its plain
PyTorch version, and the wrapper that picks one by device.  The tracker's
path runs a level's whole loop through ``gn_level``; this wrapper is the
single-step entry point and the stepwise yardstick.

Replaces ``dvo_tpu/ops/pallas/gn.py:_gn_kernel`` (via ``gn_terms_pallas``).
Both versions follow the XLA twin ``dvo_tpu.models.tracker.gn_terms``: the
kernel's header note says what bounds it on the card and how its design
answers that.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import TrackerConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu_torch.ops.warp import back_project, pixel_grid, warp_points

N_TERMS = 44  # 36 H + 6 g + r^2 + count
# One linearisation reads, per pixel, six float32 planes and three one-byte
# masks; every pixel is back-projected, transformed, projected (30 float
# operations), split into corners (4) and sampled four times (12 each);
# a pixel that passes the gates adds its Jacobian row (29), residual and
# weight (5) and its 44 products and sums (93).
BYTES_PER_PIXEL = 6 * 4 + 3
FLOPS_PER_PIXEL = 30 + 4 + 4 * 12
FLOPS_PER_VALID_PIXEL = 29 + 5 + 93


def work(shape, valid=None):
    """(bytes, float operations) of one call at ``shape`` = (h, w): every
    input read once (the planes, T_inv and the intrinsics), the 44 sums
    written once; ``valid`` pixels pass the gates (default: all)."""
    n = shape[0] * shape[1]
    valid = n if valid is None else int(valid)
    nbytes = BYTES_PER_PIXEL * n + 20 * 4 + N_TERMS * 4
    return nbytes, FLOPS_PER_PIXEL * n + FLOPS_PER_VALID_PIXEL * valid


def _level_step(cfg: TrackerConfig, level_index: int) -> float:
    return cfg.level_steps[min(level_index, len(cfg.level_steps) - 1)]


def gn_terms_plain(obj_gray, obj_mask, ref_depth, ref_sigma,
                   ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
                   K, T_inv, level_index: int, cfg: TrackerConfig):
    """Normal-equation terms over the whole image (optimize.cpp:28-90).
    Returns (H (6, 6), g (6,), residual_sum (), count () int32)."""
    h, w = obj_gray.shape
    xs, ys = pixel_grid(h, w, device=obj_gray.device)
    xy = torch.stack([xs, ys], dim=-1)
    depth = ref_depth

    warped_xy, in_front = warp_points(T_inv, xy, depth, K)
    wx, wy = warped_xy[..., 0], warped_xy[..., 1]

    i2, i2_valid = bilinear_masked(ref_gray, ref_mask, wx, wy)
    gx, _ = bilinear_dense(ref_gx, wx, wy)
    gy, _ = bilinear_dense(ref_gy, wx, wy)
    gmask_f, _ = bilinear_dense(ref_gmask.to(torch.float32), wx, wy)
    grad_ok = gmask_f > 1.0 - 1e-4

    valid = depth >= cfg.min_depth
    valid = valid & obj_mask & i2_valid
    valid = valid & (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h)
    valid = valid & in_front & grad_ok
    if level_index == cfg.crop_level:
        x0, x1 = cfg.crop_x
        y0, y1 = cfg.crop_y
        valid = valid & (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)

    pc = back_project(K, xy, depth)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    fgx = K[0, 0] * gx
    fgy = K[1, 1] * gy
    xz = x / z
    yz = y / z
    J = torch.stack(
        [
            fgx / z,
            fgy / z,
            -(fgx * x + fgy * y) / (z * z),
            -fgx * xz * yz - fgy * (1.0 + yz * yz),
            fgx * (1.0 + xz * xz) + fgy * xz * yz,
            -fgx * yz + fgy * xz,
        ],
        dim=-1,
    )

    r = i2 - obj_gray
    lo, hi = cfg.sigma_clamp
    weight = _level_step(cfg, level_index) / torch.clamp(ref_sigma, lo, hi)

    vf = valid.to(torch.float32)
    Jm = J * vf[..., None]
    if cfg.compat_weight_b_only:
        Hmat = torch.einsum("hwi,hwj->ij", Jm, Jm)
        g = torch.einsum("hwi,hw->i", Jm, r * weight * vf)
    else:
        wf = weight * vf
        Hmat = torch.einsum("hwi,hwj->ij", Jm * wf[..., None], Jm)
        g = torch.einsum("hwi,hw->i", Jm, r * wf)
    residual_sum = torch.sum(r * r * vf)
    count = torch.sum(valid.to(torch.int32)).to(torch.int32)
    return Hmat, g, residual_sum, count


def gn_terms(obj_gray, obj_mask, ref_depth, ref_sigma,
             ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
             K, T_inv, level_index: int, cfg: TrackerConfig):
    """``gn_terms_plain`` for CPU tensors; the ``csrc/gn.cu`` kernel for
    CUDA tensors (it launches or raises)."""
    if resolve_device(obj_gray) == "plain":
        return gn_terms_plain(obj_gray, obj_mask, ref_depth, ref_sigma,
                              ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
                              K, T_inv, level_index, cfg)
    h, w = obj_gray.shape
    dev = obj_gray.device
    f32, u8 = torch.float32, torch.bool
    for name, t, dtype in (
        ("obj_gray", obj_gray, f32), ("obj_mask", obj_mask, u8),
        ("ref_depth", ref_depth, f32), ("ref_sigma", ref_sigma, f32),
        ("ref_gray", ref_gray, f32), ("ref_mask", ref_mask, u8),
        ("ref_gx", ref_gx, f32), ("ref_gy", ref_gy, f32), ("ref_gmask", ref_gmask, u8),
    ):
        _build.require(t, name, dtype, (h, w), dev)
    params = torch.cat([T_inv.reshape(16), K[0, 0:1], K[1, 1:2], K[0, 2:3], K[1, 2:3]])
    _build.require(params, "params", f32, (20,), dev)

    lib = _build.library()
    partials = torch.empty((lib.dvo_gn_num_blocks(h * w), N_TERMS), dtype=f32, device=dev)
    crop = level_index == cfg.crop_level
    code = lib.dvo_gn_terms(
        obj_gray.data_ptr(), obj_mask.data_ptr(), ref_depth.data_ptr(), ref_sigma.data_ptr(),
        ref_gray.data_ptr(), ref_mask.data_ptr(), ref_gx.data_ptr(), ref_gy.data_ptr(),
        ref_gmask.data_ptr(), params.data_ptr(), partials.data_ptr(),
        h, w, _level_step(cfg, level_index), cfg.min_depth,
        cfg.sigma_clamp[0], cfg.sigma_clamp[1], int(cfg.compat_weight_b_only),
        int(crop), cfg.crop_x[0], cfg.crop_x[1], cfg.crop_y[0], cfg.crop_y[1],
        _build.stream_handle(dev),
    )
    _build.check(code, "gn_terms")
    _build.LAUNCHES["gn"] += 1
    acc = torch.sum(partials, dim=0)
    return acc[:36].reshape(6, 6), acc[36:42], acc[42], acc[43].to(torch.int32)
