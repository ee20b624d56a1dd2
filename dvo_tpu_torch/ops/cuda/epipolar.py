"""Epipolar depth observation + depth filter: the CUDA kernel
``csrc/epipolar.cu`` through its two entries, its plain PyTorch version,
and the wrappers that pick one by device.

Replaces ``dvo_tpu/ops/pallas/epipolar.py:_epipolar_kernel`` (via
``epipolar_update_pallas``).  ``epipolar_update`` is that function's
interface: it takes the 24 per-pixel planes that
``models.mapper.epipolar_fields`` prepares (plane order of the Pallas
kernel) and the born-keyframe ring itself — gray, gx, gy (C, H, W) float32
and gmask (C, H, W) bool, indexed by ring slot.  ``epipolar_fused`` is what
``models.mapper.depth_update`` launches on the card: it takes the raw maps
and a small pose table and computes the 24 values per pixel in registers;
its plain version is ``epipolar_fields`` + ``epipolar_update_plain``, which
the mapper runs on CPU tensors.  All follow the exact XLA twin
``dvo_tpu.models.mapper.depth_update``, and like it take a row block of the
reference keyframe (the tile-sharded mapper, ``parallel.mapping``): the
per-pixel planes and the outputs are the block's rows, the object frame and
the ring stay whole (``full_shape``).
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


# Per pixel: the 24 field planes read, depth, sigma and age written; per
# born-keyframe slot in use, gray, gx, gy (float32) and gmask (one byte).
# One marched sample costs its coordinates (4 float operations), the corner
# split (4), the bilinear sample (12), the squared difference (2) and the
# 3-tap SSD (5); what follows the march (triangulation, sigma model, gates,
# fusion) costs about 60 per pixel.
BYTES_PER_PIXEL = N_FIELDS * 4 + 3 * 4
BYTES_PER_SLOT_PIXEL = 3 * 4 + 1
FLOPS_PER_SAMPLE = 27
FLOPS_PER_PIXEL = 60


def marched_samples(fields, cfg: MapperConfig = MapperConfig()):
    """() int64 tensor: the samples the march takes on these inputs — for
    every pixel with a base observation, min(ceil(length) + 4, max_steps +
    4) offsets along its segment (the kernel's loop bound)."""
    length = fields[F_LENGTH][fields[F_BASE_OK] > 0.5]
    return torch.clamp(torch.ceil(length) + 4.0, max=cfg.max_steps + 4).to(torch.int64).sum()


def work(shape, slots_in_use: int, samples: int):
    """(bytes, float operations) of one ``epipolar_update`` call at
    ``shape`` = (h, w), the block's, whose pixels refer to ``slots_in_use``
    keyframe slots
    and march ``samples`` samples in all (``marched_samples``): what these
    inputs need, not the whole ring and not ``max_steps`` for every pixel."""
    n = shape[0] * shape[1]
    nbytes = BYTES_PER_PIXEL * n + BYTES_PER_SLOT_PIXEL * n * int(slots_in_use) + 3 * 4
    return nbytes, FLOPS_PER_SAMPLE * int(samples) + FLOPS_PER_PIXEL * n


# The fused entry reads, per pixel, five 4-byte planes (reference depth,
# sigma, age, the reset plane, the object frame's gray) and the object
# frame's 1-byte mask, and writes depth, sigma and age; the pose table is
# (2 + capacity) rows of 16 floats.  Preparing a pixel's 24 values costs three
# warps into another view (32 each: back-projection 6, the rigid motion 18,
# the projection 8), the segment (9), the prior and its bounds (4), the
# normalised pixel (4) and the triangulation coefficients (5 + 15 + 15 + 15).
FUSED_BYTES_PER_PIXEL = 5 * 4 + 1 + 3 * 4
FLOPS_FIELDS_PER_PIXEL = 3 * 32 + 9 + 4 + 4 + 50
TABLE_ROW = 16


def work_fused(shape, slots_in_use: int, samples: int, capacity: int):
    """(bytes, float operations) of one ``epipolar_fused`` call: the raw
    maps, the slots in use, the pose table and the four counts; the marched
    samples, the field arithmetic and what follows the march."""
    n = shape[0] * shape[1]
    nbytes = (FUSED_BYTES_PER_PIXEL * n + BYTES_PER_SLOT_PIXEL * n * int(slots_in_use)
              + 4 * TABLE_ROW * (2 + int(capacity)) + 4 * 4)
    flops = FLOPS_PER_SAMPLE * int(samples) + (FLOPS_PER_PIXEL + FLOPS_FIELDS_PER_PIXEL) * n
    return nbytes, flops


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


def march_plain(fields, born_gray, cfg: MapperConfig = MapperConfig()):
    """The masked SSD march over samples 0..S+1 (implement.cpp:106-152):
    (best_s, min_ssd), the index of the first minimum among the S windows
    (window i: offsets i, i + 1, i + 2, weights 1/3, 2/3, 1; the match lies
    at offset i + 1) and its value, ``2 * ssd_window`` where no window is
    valid."""
    f = fields
    S = cfg.max_steps + 2
    sx, sy, dx, dy = f[F_START_X], f[F_START_Y], f[F_DIR_X], f[F_DIR_Y]
    o = torch.arange(0, S + 2, dtype=torch.float32, device=f.device)[:, None, None]
    samp_v, samp_ok = _bilinear_stacked(born_gray, f[F_SLOT].long(), sx + o * dx, sy + o * dy)
    diff = samp_v - f[F_OBJ_VAL]
    diff2 = diff * diff
    w_win = (1.0 / 3.0, 2.0 / 3.0, 1.0)
    ssd = w_win[0] * diff2[:S] + w_win[1] * diff2[1:S + 1] + w_win[2] * diff2[2:S + 2]
    win_ok = samp_ok[:S] & samp_ok[1:S + 1] & samp_ok[2:S + 2]
    s_idx = torch.arange(1, S + 1, dtype=torch.float32, device=f.device)[:, None, None]
    in_march = (s_idx - 1.0) < f[F_LENGTH]
    big = 2.0 * cfg.ssd_window
    ssd = torch.where(win_ok & in_march, ssd, big)
    best_s = torch.argmin(ssd, dim=0)  # first minimum wins ties
    return best_s, torch.gather(ssd, 0, best_s[None])[0]


def epipolar_update_plain(fields, born_gray, born_gx, born_gy, born_gmask,
                          cfg: MapperConfig = MapperConfig(), full_shape=None):
    """March, match, triangulate, estimate sigma and fuse for every pixel of
    a block of rows: ``fields`` (24, bh, W) are the block's planes (they
    carry its rows' coordinates), the ring is the ``full_shape`` image
    (default: the block is the image).
    Returns (depth (bh, W), sigma (bh, W), age (bh, W) int32,
    stats (3,) int32: observed, accepted, rejected)."""
    h, w = fields.shape[1:] if full_shape is None else full_shape
    f = fields
    sx, sy, dx, dy = f[F_START_X], f[F_START_Y], f[F_DIR_X], f[F_DIR_Y]
    length = f[F_LENGTH]
    slot = f[F_SLOT].long()
    base_ok = f[F_BASE_OK] > 0.5

    best_s, min_ssd = march_plain(fields, born_gray, cfg)
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
    # A tensor numerator: ``scalar / tensor`` is ``tensor.reciprocal() * scalar``
    # in PyTorch, which rounds twice; the XLA twin and the kernel divide.
    epi = torch.full_like(g_dot_l, cfg.epipolar_sigma ** 2) / torch.clamp(g_dot_l * g_dot_l,
                                                                          min=EPS)
    lum = torch.full_like(gp2, 2.0 * cfg.luminance_sigma ** 2) / torch.clamp(gp2, min=EPS)
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


def _ring_checks(born_gray, born_gx, born_gy, born_gmask, shape, dev):
    """The ring's four (C, H, W) stacks at the full image's ``shape``;
    returns C."""
    c = born_gray.shape[0]
    for name, t in (("born_gray", born_gray), ("born_gx", born_gx), ("born_gy", born_gy)):
        _build.require(t, name, torch.float32, (c,) + tuple(shape), dev)
    _build.require(born_gmask, "born_gmask", torch.bool, (c,) + tuple(shape), dev)
    return c


def _scalars(cfg: MapperConfig):
    """The kernel's float scalars, in the order of both C entries."""
    dcfg = cfg.depth_filter
    return (cfg.ssd_window * cfg.matching_threshold_ratio, 2.0 * cfg.ssd_window,
            cfg.epipolar_sigma ** 2, 2.0 * cfg.luminance_sigma ** 2,
            cfg.accept_depth[0], cfg.accept_depth[1], cfg.accept_sigma[0], cfg.accept_sigma[1],
            dcfg.gain_ramp, dcfg.reset_sigma)


def epipolar_update(fields, born_gray, born_gx, born_gy, born_gmask,
                    cfg: MapperConfig = MapperConfig(), full_shape=None):
    """``epipolar_update_plain`` for CPU tensors; the fields entry of
    ``csrc/epipolar.cu`` for CUDA tensors (it launches or raises).  The
    block's rows lie anywhere in the image: the fields carry them."""
    if resolve_device(fields) == "plain":
        return epipolar_update_plain(fields, born_gray, born_gx, born_gy, born_gmask, cfg,
                                     full_shape)
    _, h, w = fields.shape
    full = _build.row_block((h, w), 0, full_shape)
    dev = fields.device
    _build.require(fields, "fields", torch.float32, (N_FIELDS, h, w), dev)
    c = _ring_checks(born_gray, born_gx, born_gy, born_gmask, full, dev)

    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    sigma = torch.empty_like(depth)
    age = torch.empty((h, w), dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)  # zeroed by the entry
    code = _build.library().dvo_epipolar(
        fields.data_ptr(), born_gray.data_ptr(), born_gx.data_ptr(), born_gy.data_ptr(),
        born_gmask.data_ptr(), depth.data_ptr(), sigma.data_ptr(), age.data_ptr(),
        stats.data_ptr(), *full, h, c, cfg.max_steps + 2, *_scalars(cfg),
        _build.stream_handle(dev),
    )
    _build.check(code, "epipolar")
    _build.LAUNCHES["epipolar"] += 1
    return depth, sigma, age, stats[:3]


def epipolar_fused(obj_gray, obj_mask, ref_depth, ref_sigma, ref_age, reset_depth, table,
                   born_gray, born_gx, born_gy, born_gmask, head, count,
                   cfg: MapperConfig = MapperConfig(), y_offset=0, full_shape=None):
    """The fused entry of ``csrc/epipolar.cu``: the whole depth update of
    CUDA tensors in one launch (it launches or raises; CPU tensors go through
    ``models.mapper.depth_update``, which runs the plain versions).

    ``obj_gray``/``obj_mask``: the object frame's base level; ``ref_depth``,
    ``ref_sigma`` float32 and ``ref_age`` int32: the reference keyframe's
    maps, or their rows [y_offset, y_offset + bh) of a ``full_shape`` image
    (default: the whole image); ``reset_depth``: the depth filter's reset
    plane for the same pixels; ``table``: the
    (2 + C, 16) pose table of ``models.mapper.pose_table``; the ring stacks
    (C, H, W); ``head``/``count``: the ring's newest slot and live keyframes,
    0-d int32 tensors on the card, which the kernel reads there (nothing is
    read back to the host, so the update can be enqueued ahead of the host
    and captured in a CUDA graph).  Returns (depth, sigma, age int32, stats (4,) int32: observed, accepted,
    rejected, aged_out)."""
    if resolve_device(ref_depth) != "cuda":
        raise ValueError("epipolar_fused takes CUDA tensors; on the CPU use "
                         "models.mapper.depth_update")
    h, w = ref_depth.shape
    full = _build.row_block((h, w), y_offset, full_shape)
    dev = ref_depth.device
    for name, t, shape in (("obj_gray", obj_gray, full), ("ref_depth", ref_depth, (h, w)),
                           ("ref_sigma", ref_sigma, (h, w)), ("reset_depth", reset_depth, (h, w))):
        _build.require(t, name, torch.float32, shape, dev)
    _build.require(obj_mask, "obj_mask", torch.bool, full, dev)
    _build.require(ref_age, "ref_age", torch.int32, (h, w), dev)
    c = _ring_checks(born_gray, born_gx, born_gy, born_gmask, full, dev)
    _build.require(table, "table", torch.float32, (2 + c, TABLE_ROW), dev)
    _build.require(head, "head", torch.int32, (), dev)
    _build.require(count, "count", torch.int32, (), dev)

    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    sigma = torch.empty_like(depth)
    age = torch.empty((h, w), dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)  # zeroed by the entry
    code = _build.library().dvo_epipolar_fused(
        obj_gray.data_ptr(), obj_mask.data_ptr(), ref_depth.data_ptr(), ref_sigma.data_ptr(),
        ref_age.data_ptr(), reset_depth.data_ptr(), table.data_ptr(), born_gray.data_ptr(),
        born_gx.data_ptr(), born_gy.data_ptr(), born_gmask.data_ptr(), depth.data_ptr(),
        sigma.data_ptr(), age.data_ptr(), stats.data_ptr(), head.data_ptr(), count.data_ptr(),
        *full, h, int(y_offset), c, cfg.max_steps + 2,
        cfg.crop_x[0], cfg.crop_x[1], cfg.crop_y[0], cfg.crop_y[1],
        cfg.min_search_depth, *_scalars(cfg), _build.stream_handle(dev),
    )
    _build.check(code, "epipolar (fused)")
    _build.LAUNCHES["epipolar"] += 1
    return depth, sigma, age, stats
