"""Epipolar depth observation + depth filter: the CUDA kernel
``csrc/epipolar.cu``, its plain PyTorch version, and the wrapper that picks
one by device.

Replaces ``dvo_tpu/ops/pallas/epipolar.py:_epipolar_kernel`` (via
``epipolar_update_pallas``).  Both versions take the 24 per-pixel planes
that ``models.mapper.depth_update`` prepares (plane order of the Pallas
kernel) and the born-keyframe ring itself — gray, gx, gy (C, H, W) float32
and gmask (C, H, W) bool, indexed by ring slot — and follow the exact XLA
twin ``dvo_tpu.models.mapper.depth_update``.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import MapperConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.depth_filter import gaussian_update_with_reset
from dvo_tpu_torch.ops.sampling import clipped_corners, corners

(
    F_START_X, F_START_Y, F_DIR_X, F_DIR_Y, F_LENGTH, F_OBJ_VAL, F_SLOT,
    F_PRIOR_D, F_PRIOR_S, F_DMIN, F_DMAX,
    F_R3Q, F_KRQ0, F_KRQ1, F_KRQ2, F_TTZ, F_KT0, F_KT1, F_KT2,
    F_REF_DEPTH, F_REF_SIGMA, F_REF_AGE, F_BASE_OK, F_RESET_D,
) = range(24)
N_FIELDS = 24
EPS = 1e-6


def _bilinear_stacked(img, slot, x, y):
    """Dense bilinear over a (C, H, W) stack with a per-point slot
    (getSubpixelFromDense: out-of-range +1 corners fall back to the base
    corner; the base corner's in-range flag is the validity)."""
    _, h, w = img.shape
    x0, y0, fx, fy, in0, in_x1, in_y1 = corners(x, y, w, h)
    x0c, x1c, y0c, y1c = clipped_corners(x0, y0, w, h)
    g00 = img[slot, y0c, x0c]
    g10 = torch.where(in_x1, img[slot, y0c, x1c], g00)
    g01 = torch.where(in_y1, img[slot, y1c, x0c], g00)
    g11 = torch.where(in_x1 & in_y1, img[slot, y1c, x1c], g00)
    top = g00 * (1 - fx) + g10 * fx
    bot = g01 * (1 - fx) + g11 * fx
    return top * (1 - fy) + bot * fy, in0


def epipolar_update_plain(fields, born_gray, born_gx, born_gy, born_gmask,
                          cfg: MapperConfig = MapperConfig()):
    """March, match, triangulate, estimate sigma and fuse for every pixel.
    Returns (depth (H, W), sigma (H, W), age (H, W) int32,
    stats (3,) int32: observed, accepted, rejected)."""
    _, h, w = fields.shape
    f = fields
    S = cfg.max_steps + 2
    sx, sy, dx, dy = f[F_START_X], f[F_START_Y], f[F_DIR_X], f[F_DIR_Y]
    length = f[F_LENGTH]
    slot = f[F_SLOT].long()
    base_ok = f[F_BASE_OK] > 0.5

    # --- masked SSD march over samples 0..S+1 (implement.cpp:106-152) ---
    o = torch.arange(0, S + 2, dtype=torch.float32, device=f.device)[:, None, None]
    samp_v, samp_ok = _bilinear_stacked(born_gray, slot, sx + o * dx, sy + o * dy)
    diff = samp_v - f[F_OBJ_VAL]
    diff2 = diff * diff
    w_win = (1.0 / 3.0, 2.0 / 3.0, 1.0)
    ssd = w_win[0] * diff2[:S] + w_win[1] * diff2[1:S + 1] + w_win[2] * diff2[2:S + 2]
    win_ok = samp_ok[:S] & samp_ok[1:S + 1] & samp_ok[2:S + 2]
    s_idx = torch.arange(1, S + 1, dtype=torch.float32, device=f.device)[:, None, None]
    in_march = (s_idx - 1.0) < length
    big = 2.0 * cfg.ssd_window
    ssd = torch.where(win_ok & in_march, ssd, big)
    best_s = torch.argmin(ssd, dim=0)  # first minimum wins ties
    min_ssd = torch.gather(ssd, 0, best_s[None])[0]
    match_ok = min_ssd <= cfg.ssd_window * cfg.matching_threshold_ratio
    best_o = (best_s + 1).to(torch.float32)
    mx = sx + best_o * dx
    my = sy + best_o * dy
    match_ok = match_ok & (mx >= 0) & (my >= 0) & (mx <= w) & (my <= h)

    # --- nearest gradient sample at the match (rint: half to even) ---
    bxi = torch.round(mx).to(torch.int32)
    byi = torch.round(my).to(torch.int32)
    g_in = (bxi >= 0) & (bxi < w) & (byi >= 0) & (byi < h)
    bxc = torch.clamp(bxi, 0, w - 1).long()
    byc = torch.clamp(byi, 0, h - 1).long()
    gxv = born_gx[slot, byc, bxc]
    gyv = born_gy[slot, byc, bxc]
    g_ok = g_in & born_gmask[slot, byc, bxc]

    # --- triangulation (implement.cpp:49-71) ---
    r3q = f[F_R3Q]
    a0 = r3q * mx - f[F_KRQ0]
    a1 = r3q * my - f[F_KRQ1]
    a2 = r3q - f[F_KRQ2]
    ttz = f[F_TTZ]
    b0 = ttz * mx - f[F_KT0]
    b1 = ttz * my - f[F_KT1]
    b2 = ttz - f[F_KT2]
    a_dot_a = a0 * a0 + a1 * a1 + a2 * a2
    a_dot_b = a0 * b0 + a1 * b1 + a2 * b2
    new_depth = -a_dot_b / torch.where(a_dot_a < 1e-20, 1.0, a_dot_a)

    # --- sigma model (implement.cpp:73-104) ---
    g_dot_l = torch.abs(gxv * (-dx) + gyv * (-dy))
    gp2 = g_dot_l / length
    epi = cfg.epipolar_sigma ** 2 / torch.clamp(g_dot_l * g_dot_l, min=EPS)
    lum = 2.0 * cfg.luminance_sigma ** 2 / torch.clamp(gp2, min=EPS)
    alpha = (f[F_DMAX] - f[F_DMIN]) / length
    new_sigma = alpha * torch.sqrt(epi + lum)

    # --- observation gates (mapper.cpp:122) ---
    obs_ok = base_ok & match_ok & g_ok
    obs_ok = obs_ok & (new_depth > cfg.accept_depth[0]) & (new_depth < cfg.accept_depth[1])
    obs_ok = obs_ok & (new_sigma > cfg.accept_sigma[0]) & (new_sigma < cfg.accept_sigma[1])

    # --- fusion with reset (mapper.cpp:124-131) ---
    fused_d, fused_s, accepted = gaussian_update_with_reset(
        f[F_PRIOR_D], f[F_PRIOR_S], new_depth, new_sigma, f[F_RESET_D],
        obs_valid=obs_ok, cfg=cfg.depth_filter,
    )
    rejected = obs_ok & ~accepted
    depth = torch.where(obs_ok, fused_d, f[F_REF_DEPTH])
    sigma = torch.where(obs_ok, fused_s, f[F_REF_SIGMA])
    age = torch.where(rejected, 0, f[F_REF_AGE].to(torch.int32))
    stats = torch.stack([obs_ok.sum(), accepted.sum(), rejected.sum()]).to(torch.int32)
    return depth, sigma, age, stats


def epipolar_update(fields, born_gray, born_gx, born_gy, born_gmask,
                    cfg: MapperConfig = MapperConfig()):
    """``epipolar_update_plain`` for CPU tensors; the ``csrc/epipolar.cu``
    kernel for CUDA tensors (it launches or raises)."""
    if resolve_device(fields) == "plain":
        return epipolar_update_plain(fields, born_gray, born_gx, born_gy, born_gmask, cfg)
    _, h, w = fields.shape
    c = born_gray.shape[0]
    dev = fields.device
    _build.require(fields, "fields", torch.float32, (N_FIELDS, h, w), dev)
    for name, t in (("born_gray", born_gray), ("born_gx", born_gx), ("born_gy", born_gy)):
        _build.require(t, name, torch.float32, (c, h, w), dev)
    _build.require(born_gmask, "born_gmask", torch.bool, (c, h, w), dev)

    lib = _build.library()
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    sigma = torch.empty_like(depth)
    age = torch.empty((h, w), dtype=torch.int32, device=dev)
    partials = torch.empty((lib.dvo_epipolar_num_blocks(h * w), 3), dtype=torch.int32,
                           device=dev)
    dcfg = cfg.depth_filter
    code = lib.dvo_epipolar(
        fields.data_ptr(), born_gray.data_ptr(), born_gx.data_ptr(), born_gy.data_ptr(),
        born_gmask.data_ptr(), depth.data_ptr(), sigma.data_ptr(), age.data_ptr(),
        partials.data_ptr(), h, w, c, cfg.max_steps + 2,
        cfg.ssd_window * cfg.matching_threshold_ratio, 2.0 * cfg.ssd_window,
        cfg.epipolar_sigma ** 2, 2.0 * cfg.luminance_sigma ** 2,
        cfg.accept_depth[0], cfg.accept_depth[1], cfg.accept_sigma[0], cfg.accept_sigma[1],
        dcfg.gain_ramp, dcfg.reset_sigma, _build.stream_handle(dev),
    )
    _build.check(code, "epipolar")
    _build.LAUNCHES["epipolar"] += 1
    return depth, sigma, age, torch.sum(partials, dim=0, dtype=torch.int32)
