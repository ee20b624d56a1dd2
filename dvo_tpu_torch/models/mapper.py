"""Mapping: keyframe policy, propagate, regularize and the epipolar depth
update — ``dvo_tpu.models.mapper`` ported (reference mapper.cpp,
implement.cpp).

``depth_update`` on CUDA tensors is one launch of ``csrc/epipolar.cu``'s
fused entry, which takes the raw maps, the keyframe ring and a small pose
table (``pose_table``: a handful of ops on (C, 6) tensors per frame) and
computes everything per pixel in registers.  On CPU tensors it is
``depth_update_by_fields``: ``epipolar_fields`` prepares the kernel's 24
per-pixel planes in plain PyTorch, as ``depth_update_pallas`` prepares them
in XLA, and ``ops/cuda/epipolar.epipolar_update`` takes them with the full
ring.  ``regularize`` is ``ops/cuda/regularize``.  The kernels' plain
versions follow the exact XLA twins, which are what the port is held to.
Like ``dvo_tpu``'s, the depth update takes a row block of the reference
maps (``y_offset``, ``full_shape``): the hook of the tile-sharded mapper
(``parallel.mapping``).
"""

from __future__ import annotations

import dataclasses

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import EPSILON, InitConfig, MapperConfig, resolve_device
from dvo_tpu_torch.models.frame import Scene
from dvo_tpu_torch.models.history import KeyframeHistory, born_slot
from dvo_tpu_torch.ops.cuda import epipolar
from dvo_tpu_torch.ops.cuda.regularize import regularize  # noqa: F401  (re-export)
from dvo_tpu_torch.ops.warp import back_project, pixel_grid, project

EPS = 1e-6


def need_new_keyframe(rel_xi, frame_id, ref_id, cfg: MapperConfig):
    """Translation > min_movement or >= max_forward frames since the
    keyframe (mapper.cpp:45-60).  ``frame_id``/``ref_id``: 0-d int32
    tensors (or ints).  A device bool scalar."""
    moved = torch.linalg.vector_norm(rel_xi[:3]) > cfg.min_movement
    return moved | ((frame_id - ref_id) >= cfg.max_forward)


def propagate(ref_depth, ref_sigma, ref_age, rel_xi, K,
              cfg: MapperConfig = MapperConfig(), init: InitConfig = InitConfig()):
    """Forward-warp the keyframe depth into the new keyframe
    (implement.cpp:217-256): d1 = d0 + tz, sigma grown by (d1/d0)^4 plus the
    prediction variance, age + 1; unwritten pixels get depth 1, sigma 1,
    age 0.  Collisions: nearest depth wins, ties by source raster id.

    The scatter-min key is int64 (quantised depth << 32 | source id).  The
    JAX package packs only 15 bits of the source id, so its winner wraps
    for images over 32768 pixels; below that both give the same result."""
    h, w = ref_depth.shape
    xs, ys = pixel_grid(h, w, device=ref_depth.device)
    xy = torch.stack([xs, ys], dim=-1)
    T = lie.se3_exp(rel_xi)
    warped, in_front = project(K, lie.transform(T, back_project(K, xy, ref_depth)))
    tx = torch.round(warped[..., 0]).to(torch.int32)  # rint: half to even
    ty = torch.round(warped[..., 1]).to(torch.int32)
    valid = (torch.abs(ref_depth) >= EPS) & in_front
    valid = valid & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)

    d0 = torch.clamp(ref_depth, min=0.01)
    d1 = d0 + rel_xi[2]
    ratio = d1 / d0
    sig1 = torch.sqrt(ratio ** 4 * ref_sigma ** 2 + cfg.predict_sigma ** 2)
    d1 = torch.clamp(d1, min=0.0)
    age1 = ref_age + 1

    n = h * w
    big = torch.iinfo(torch.int64).max
    src = torch.arange(n, dtype=torch.int64, device=ref_depth.device)
    tgt = torch.where(valid, ty * w + tx, n).reshape(-1).long()
    dq = torch.clamp(torch.round(d1 * 4096.0), 0, (1 << 16) - 1).to(torch.int64)
    key = torch.where(valid.reshape(-1), (dq.reshape(-1) << 32) | src, big)
    slots = torch.full((n + 1,), big, dtype=torch.int64, device=ref_depth.device)
    slots.scatter_reduce_(0, tgt, key, reduce="amin")
    written = slots[:n] != big
    winner = torch.where(written, slots[:n] & 0xFFFFFFFF, 0)

    depth_out = torch.where(written, d1.reshape(-1)[winner], init.propagate_depth)
    sigma_out = torch.where(written, sig1.reshape(-1)[winner], init.propagate_sigma)
    age_out = torch.where(written, age1.reshape(-1)[winner], 0)
    return depth_out.reshape(h, w), sigma_out.reshape(h, w), age_out.reshape(h, w).to(ref_age.dtype)


@dataclasses.dataclass(frozen=True)
class DepthUpdateStats:
    observed: torch.Tensor   # () int32 pixels with a gated-valid observation
    accepted: torch.Tensor   # () int32 observations fused
    rejected: torch.Tensor   # () int32 observations rejected -> reset, age 0
    aged_out: torch.Tensor   # () int32 pixels whose born keyframe left the ring

    @staticmethod
    def zero(device=None) -> "DepthUpdateStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return DepthUpdateStats(observed=z, accepted=z, rejected=z, aged_out=z)


def pose_table(K, obj_xi_w, rel_xi, history: KeyframeHistory):
    """The (2 + C, 16) float32 table of everything ``depth_update`` needs
    that does not depend on the pixel: row 0 ``K`` (row-major, 9 values),
    row 1 ``T_rel = exp(rel_xi)`` (R row-major, then t) and ``rel_xi[2]``,
    row 2 + c, for ring slot c, ``T_es = exp(-r_xi)`` with ``r_xi =
    compose(obj_xi_w, -history.xi[c])`` (R, then t) and ``t_tw =
    -r_xi[:3]`` (mapper.cpp:107, implement.cpp:57-59).  All trigonometry of
    the update is in here."""
    c = history.capacity
    # One exp for the three twists that need one: the object frame's pose,
    # the ring's inverse poses and the relative pose (eager PyTorch pays per
    # op, not per row).
    T = lie.se3_exp(torch.cat([obj_xi_w[None], -history.xi, rel_xi[None]]))
    T_rel = T[c + 1]
    r_xi = lie.se3_log(T[0] @ T[1:c + 1])                    # compose(obj_xi_w, -xi): (C, 6)
    T_es = lie.se3_exp(-r_xi)                                # (C, 4, 4)
    table = torch.zeros((2 + c, epipolar.TABLE_ROW), dtype=torch.float32, device=K.device)
    table[0, :9] = K.reshape(9)
    table[1, :9] = T_rel[:3, :3].reshape(9)
    table[1, 9:12] = T_rel[:3, 3]
    table[1, 12] = rel_xi[2]
    table[2:, :9] = T_es[:, :3, :3].reshape(c, 9)
    table[2:, 9:12] = T_es[:, :3, 3]
    table[2:, 12:15] = -r_xi[:, :3]
    return table


def _warp_point(K, T, x, y, d):
    """project(K, R back_project(K, (x, y), d) + t) with every product
    written as an explicit sum, left to right — the order
    ``csrc/epipolar_pixel.cuh`` (``warp_point``) copies term by term, so the
    kernel's coordinates have these bits.  ``K``: 9 values (row-major);
    ``T``: R row-major at 0..8, t at 9..11, scalars or per-pixel planes.
    Returns (u, v, in_front)."""
    fx, cx, fy, cy = K[0], K[2], K[4], K[5]
    X = d * (x - cx) / fx
    Y = d * (y - cy) / fy
    px = T[0] * X + T[1] * Y + T[2] * d + T[9]
    py = T[3] * X + T[4] * Y + T[5] * d + T[10]
    pz = T[6] * X + T[7] * Y + T[8] * d + T[11]
    safe = torch.where(torch.abs(pz) < EPSILON, 1.0, pz)
    return px * fx / safe + cx, py * fy / safe + cy, pz > EPSILON


def epipolar_fields(obj: Scene, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age,
                    history: KeyframeHistory, reset_depth, cfg: MapperConfig,
                    y_offset=0, full_shape=None):
    """The kernel's 24 per-pixel planes (order of ``ops/cuda/epipolar``)
    and the aged-out count: steps 1-4a and the triangulation coefficients
    of ``dvo_tpu.models.mapper.depth_update``.  ``ref_depth``,
    ``ref_sigma``, ``ref_age`` and ``reset_depth`` may be rows [y_offset,
    y_offset + bh) of a ``full_shape`` image; ``obj`` and ``history`` stay
    full-size.

    The plain version of what the fused entry computes in registers
    (``csrc/epipolar_pixel.cuh``: ``prepare``): every 3x3 product is an
    explicit sum in one fixed order rather than a batched matmul, whose
    summation order is the library's, so that a coordinate never differs by
    an ulp between the two and no ``rint``, gate or argmin flips."""
    bh, bw = ref_depth.shape
    h, w = (bh, bw) if full_shape is None else full_shape
    xs, ys = pixel_grid(bh, bw, device=ref_depth.device)
    ys = ys + y_offset
    table = pose_table(obj.K, obj_xi_w, rel_xi, history)
    K = table[0].unbind()
    T_rel = table[1].unbind()

    # --- 1. ref pixel -> obj pixel, rounded half to even (mapper.cpp:94) ---
    u, v, in_front = _warp_point(K, T_rel, xs, ys, ref_depth)
    ox = torch.round(u).to(torch.int32)
    oy = torch.round(v).to(torch.int32)
    in_obj = (ox >= 0) & (ox < w) & (oy >= 0) & (oy < h)
    oxc = torch.clamp(ox, 0, w - 1)
    oyc = torch.clamp(oy, 0, h - 1)
    obj_val = obj.gray[oyc.long(), oxc.long()]
    obj_ok = obj.mask[oyc.long(), oxc.long()]

    x0c, x1c = cfg.crop_x
    y0c, y1c = cfg.crop_y
    crop = (xs >= x0c) & (xs <= x1c) & (ys >= y0c) & (ys <= y1c)
    aged_ok = ref_age < history.count
    aged_out = torch.sum(crop & ~aged_ok).to(torch.int32)
    pix_ok = crop & in_obj & in_front & obj_ok & aged_ok

    # --- 2. born keyframe: the slot's row of the table, gathered per pixel ---
    slot = born_slot(history, ref_age).long()
    E = table[2:][slot].unbind(dim=-1)        # 16 (H, W) planes: R, t, t_tw

    # --- 3. prior; 4a. epipolar segment in the born image ---
    prior_d = ref_depth - T_rel[12]
    prior_s = ref_sigma
    oxf, oyf = oxc.to(torch.float32), oyc.to(torch.float32)
    dmin = torch.clamp(prior_d - prior_s, min=cfg.min_search_depth)
    dmax = prior_d + prior_s
    start_x, start_y, start_front = _warp_point(K, E, oxf, oyf, dmax)
    end_x, end_y, end_front = _warp_point(K, E, oxf, oyf, dmin)
    seg_x = end_x - start_x
    seg_y = end_y - start_y
    length = torch.sqrt(seg_x * seg_x + seg_y * seg_y + 1e-20)
    seg_ok = (length > 1e-6) & start_front & end_front & (dmax > dmin)

    # --- triangulation coefficients (implement.cpp:49-71) ---
    q0 = (oxf - K[2]) / K[0]                  # back_project at depth 1
    q1 = (oyf - K[5]) / K[4]
    r3_dot_q = E[6] * q0 + E[7] * q1 + E[8]
    r0 = E[0] * q0 + E[1] * q1 + E[2]
    r1 = E[3] * q0 + E[4] * q1 + E[5]
    KRq = [K[3 * i] * r0 + K[3 * i + 1] * r1 + K[3 * i + 2] * r3_dot_q for i in range(3)]
    t_tw = E[12:15]
    Kt = [K[3 * i] * t_tw[0] + K[3 * i + 1] * t_tw[1] + K[3 * i + 2] * t_tw[2]
          for i in range(3)]

    fields = torch.stack(
        [
            start_x, start_y, seg_x / length, seg_y / length,
            length, obj_val, slot.to(torch.float32),
            prior_d, prior_s, dmin, dmax,
            r3_dot_q, KRq[0], KRq[1], KRq[2],
            t_tw[2], Kt[0], Kt[1], Kt[2],
            ref_depth, ref_sigma, ref_age.to(torch.float32),
            (pix_ok & seg_ok).to(torch.float32), reset_depth,
        ],
        dim=0,
    )
    return fields, aged_out


def depth_update_by_fields(obj: Scene, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age,
                           history: KeyframeHistory, reset_depth,
                           cfg: MapperConfig = MapperConfig(), y_offset=0, full_shape=None):
    """``depth_update`` through the 24 prepared planes: ``epipolar_fields``
    in PyTorch ops, then ``ops/cuda/epipolar.epipolar_update`` (its plain
    version on CPU tensors, the kernel's fields entry on CUDA tensors).  The
    plain version of the fused entry."""
    fields, aged_out = epipolar_fields(obj, obj_xi_w, rel_xi, ref_depth, ref_sigma,
                                       ref_age, history, reset_depth, cfg, y_offset, full_shape)
    depth, sigma, age, stats = epipolar.epipolar_update(
        fields, history.gray, history.gx, history.gy, history.gmask, cfg, full_shape
    )
    return depth, sigma, age.to(ref_age.dtype), DepthUpdateStats(
        observed=stats[0], accepted=stats[1], rejected=stats[2], aged_out=aged_out,
    )


def depth_update(obj: Scene, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age,
                 history: KeyframeHistory, reset_depth, cfg: MapperConfig = MapperConfig(),
                 y_offset=0, full_shape=None):
    """Per-pixel epipolar observation + fusion (Mapper::update,
    mapper.cpp:76-137) over the reference keyframe's base level.
    ``reset_depth`` (H, W) is the reset prior for rejected observations
    (``ops.depth_filter.draw_reset_depth``).  ``ref_depth``, ``ref_sigma``,
    ``ref_age`` and ``reset_depth`` may be rows [y_offset, y_offset + bh) of
    a ``full_shape`` image (``obj`` and ``history`` stay full-size); the
    outputs are then those rows.  CUDA tensors: the pose table and one
    launch of the fused entry; CPU tensors: ``depth_update_by_fields``.
    Returns (depth, sigma, age, DepthUpdateStats)."""
    if resolve_device(ref_depth) == "plain":
        return depth_update_by_fields(obj, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age,
                                      history, reset_depth, cfg, y_offset, full_shape)
    depth, sigma, age, stats = epipolar.epipolar_fused(
        obj.gray, obj.mask, ref_depth, ref_sigma, ref_age, reset_depth,
        pose_table(obj.K, obj_xi_w, rel_xi, history),
        history.gray, history.gx, history.gy, history.gmask, history.head, history.count, cfg,
        y_offset, full_shape,
    )  # head and count stay on the device: the kernel reads them there
    return depth, sigma, age, DepthUpdateStats(
        observed=stats[0], accepted=stats[1], rejected=stats[2], aged_out=stats[3],
    )
