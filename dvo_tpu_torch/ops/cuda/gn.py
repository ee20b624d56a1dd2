"""GN linearisation (one step): the CUDA kernel ``csrc/gn.cu``, its plain
PyTorch version, and the wrappers that pick one by device.  The tracker's
path runs a level's whole loop through ``gn_level``; this is the
single-step entry point: the tile-sharded tracker's step (one launch per
rank and GN step on its row block, ``parallel.tracking``) and the stepwise
yardstick.

Replaces ``dvo_tpu/ops/pallas/gn.py:_gn_kernel`` (via ``gn_terms_pallas``).
Both versions follow the XLA twin ``dvo_tpu.models.tracker.gn_terms``: the
kernel's header note says what bounds it on the card and how its design
answers that.  Like the twin, both take a row block: the object planes and
the reference depth and sigma are rows [y_offset, y_offset + h) of a
``full_shape`` image whose gather planes (reference gray, mask, gradients)
are given whole — the hook of the tile-sharded tracker
(``parallel.tracking``).

The kernel writes 29 sums (``N_SUMS``): H's lower triangle in row order
(entry a (a + 1) / 2 + b is H[a, b], b <= a), g, the residual sum and the
count (a float, exact below 2**24 pixels).  ``pack_sums`` and
``unpack_sums`` convert between them and (H, g, residual_sum, count).
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import TrackerConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu_torch.ops.warp import back_project, pixel_grid, warp_points

N_SUMS = 29   # 21 lower-triangle H + 6 g + r^2 + count
THREADS = 256  # csrc/gn.cu kThreads (work()'s count; launches ask the library)
PLANE_NAMES = ("obj_gray", "obj_mask", "ref_depth", "ref_sigma", "ref_gray", "ref_mask",
               "ref_gx", "ref_gy", "ref_gmask")
# One linearisation reads, per pixel, six float32 planes and three one-byte
# masks; every pixel is back-projected, transformed, projected (30 float
# operations), split into corners (4) and sampled four times (12 each);
# a pixel that passes the gates adds its Jacobian row (29), residual and
# weight (5) and its 29 products and sums (63).
BYTES_PER_PIXEL = 6 * 4 + 3
FLOPS_PER_PIXEL = 30 + 4 + 4 * 12
FLOPS_PER_VALID_PIXEL = 29 + 5 + 63


def num_blocks(n: int) -> int:
    """Thread blocks (and partials slots) of a launch over ``n`` pixels."""
    return -(-n // THREADS)


def work(shape, valid=None):
    """(bytes, float operations) of one launch at ``shape`` = (h, w), the
    block's: every input read once (the block's planes, T_inv's three rows
    and the four intrinsics; a gather plane counted once for each of the
    block's pixels) and the 29 sums written once (the blocks' partials
    slots are the design's scratch, not the function's traffic); ``valid``
    pixels pass the gates (default: all)."""
    n = shape[0] * shape[1]
    valid = n if valid is None else int(valid)
    nbytes = BYTES_PER_PIXEL * n + (12 + 4) * 4 + N_SUMS * 4
    return nbytes, FLOPS_PER_PIXEL * n + FLOPS_PER_VALID_PIXEL * valid


def _level_step(cfg: TrackerConfig, level_index: int) -> float:
    return cfg.level_steps[min(level_index, len(cfg.level_steps) - 1)]


_MIRRORS = {}


def _mirror(device) -> torch.Tensor:
    """(36,) index of H[i, j] in the 29 sums, made on ``device`` once (by
    device ops: no copy from the host)."""
    idx = _MIRRORS.get(device)
    if idx is None:
        i = torch.arange(6, device=device)
        hi = torch.maximum(i[:, None], i[None, :])
        lo = torch.minimum(i[:, None], i[None, :])
        idx = _MIRRORS[device] = (hi * (hi + 1) // 2 + lo).reshape(36)
    return idx


def pack_sums(Hmat, g, residual_sum, count) -> torch.Tensor:
    """(H, g, residual_sum, count) as the kernel's 29 sums: H's lower
    triangle in row order, g, the residual sum, the count as a float."""
    rows, cols = torch.tril_indices(6, 6, device=Hmat.device)
    return torch.cat([Hmat[rows, cols], g, residual_sum.reshape(1),
                      count.reshape(1).to(torch.float32)])


def unpack_sums(sums):
    """The 29 sums as (H (6, 6), mirrored from its lower triangle, g (6,),
    residual_sum (), count () int32): one gather and one cast."""
    return (sums[_mirror(sums.device)].reshape(6, 6), sums[21:27], sums[27],
            sums[28].to(torch.int32))


def gn_terms_plain(obj_gray, obj_mask, ref_depth, ref_sigma,
                   ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
                   K, T_inv, level_index: int, cfg: TrackerConfig,
                   y_offset=0, full_shape=None):
    """Normal-equation terms over a row block of the image
    (optimize.cpp:28-90): the block's pixels on rows [y_offset, y_offset +
    h) of a ``full_shape`` image (default: the block is the image).
    Returns (H (6, 6), g (6,), residual_sum (), count () int32)."""
    h, w = obj_gray.shape
    full_h, full_w = (h, w) if full_shape is None else full_shape
    xs, ys = pixel_grid(h, w, device=obj_gray.device)
    ys = ys + y_offset
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
    valid = valid & (wx >= 0) & (wx < full_w) & (wy >= 0) & (wy < full_h)
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


def _ticket(device, stream: int) -> torch.Tensor:
    """The kernel's ticket for launches on ``stream``: one zeroed int,
    made once; every launch leaves it at 0."""
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


_TICKETS = {}


def terms_launcher(planes, K, level_index: int, cfg: TrackerConfig, y_offset=0,
                   full_shape=None):
    """The linearisation of ``planes`` (the nine of ``gn_level``, the first
    four the block's rows, the rest the full image's), checked once.
    Returns ``launch(T_inv, sums)``, which writes the 29 sums into ``sums``
    at the pose whose T_inv rows 0-2 are the first 12 floats of ``T_inv``
    (a 4x4, or a step kernel's state).  On CPU tensors ``launch`` runs
    ``gn_terms_plain``; on CUDA tensors each call is one ``csrc/gn.cu``
    launch on the stream that was current here (it launches or raises)."""
    obj_gray = planes[0]
    if resolve_device(obj_gray) == "plain":
        def launch_plain(T_inv, sums):
            T = torch.cat([T_inv.reshape(-1)[:12], T_inv.new_tensor([0.0, 0.0, 0.0, 1.0])])
            sums.copy_(pack_sums(*gn_terms_plain(*planes, K, T.reshape(4, 4), level_index, cfg,
                                                 y_offset, full_shape)))
            return sums

        return launch_plain
    h, w = obj_gray.shape
    full = _build.row_block((h, w), y_offset, full_shape)
    dev = obj_gray.device
    f32, u8 = torch.float32, torch.bool
    if len(planes) != len(PLANE_NAMES):
        raise ValueError(f"{len(planes)} planes, expected {len(PLANE_NAMES)}")
    for i, (name, t) in enumerate(zip(PLANE_NAMES, planes)):
        _build.require(t, name, u8 if name.endswith("mask") else f32, (h, w) if i < 4 else full,
                       dev)
    _build.require(K, "K", f32, (3, 3), dev)
    lib = _build.library()
    stream = _build.stream_handle(dev)
    # the launch's scratch: held by the closure, so that no other tensor gets
    # its memory while launches may still write it
    partials = torch.empty((lib.dvo_gn_num_blocks(h * w), N_SUMS), dtype=f32, device=dev)
    ticket = _ticket(dev, stream)
    head = (*(t.data_ptr() for t in planes), K.data_ptr())
    crop = level_index == cfg.crop_level
    scalars = (h, w, int(y_offset), *full, _level_step(cfg, level_index), cfg.min_depth,
               cfg.sigma_clamp[0], cfg.sigma_clamp[1], int(cfg.compat_weight_b_only),
               int(crop), cfg.crop_x[0], cfg.crop_x[1], cfg.crop_y[0], cfg.crop_y[1], stream)

    def launch(T_inv, sums):
        _build.require(T_inv, "T_inv", f32, tuple(T_inv.shape), dev)
        if T_inv.numel() < 12:
            raise ValueError(f"T_inv: {T_inv.numel()} floats, expected its 12 rows")
        _build.require(sums, "sums", f32, (N_SUMS,), dev)
        code = lib.dvo_gn_terms(*head, T_inv.data_ptr(), sums.data_ptr(), partials.data_ptr(),
                                ticket.data_ptr(), *scalars)
        _build.check(code, "gn_terms")
        _build.LAUNCHES["gn"] += 1
        return sums

    return launch


def gn_terms(obj_gray, obj_mask, ref_depth, ref_sigma,
             ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
             K, T_inv, level_index: int, cfg: TrackerConfig,
             y_offset=0, full_shape=None):
    """``gn_terms_plain`` for CPU tensors; for CUDA tensors one
    ``csrc/gn.cu`` launch, and H mirrored from its lower triangle (it
    launches or raises).  Returns (H (6, 6), g (6,), residual_sum (), count
    () int32)."""
    planes = (obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray, ref_mask, ref_gx, ref_gy,
              ref_gmask)
    if resolve_device(obj_gray) == "plain":
        return gn_terms_plain(*planes, K, T_inv, level_index, cfg, y_offset, full_shape)
    launch = terms_launcher(planes, K, level_index, cfg, y_offset, full_shape)
    _build.require(T_inv, "T_inv", torch.float32, (4, 4), obj_gray.device)
    sums = torch.empty(N_SUMS, dtype=torch.float32, device=obj_gray.device)
    return unpack_sums(launch(T_inv, sums))
