"""Mapping: keyframe policy, propagate, regularize and the epipolar depth
update — ``dvo_tpu.models.mapper`` ported (reference mapper.cpp,
implement.cpp).

``depth_update`` prepares the epipolar kernel's 24 per-pixel planes in
plain PyTorch, as ``depth_update_pallas`` prepares them in XLA, and hands
them with the full keyframe ring to ``ops/cuda/epipolar``; ``regularize`` is
``ops/cuda/regularize``.  Both kernels' plain versions follow the exact XLA
twins, which are what the port is held to.
"""

from __future__ import annotations

import dataclasses

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import InitConfig, MapperConfig
from dvo_tpu_torch.models.frame import Scene
from dvo_tpu_torch.models.history import KeyframeHistory, born_slot
from dvo_tpu_torch.ops.cuda import epipolar
from dvo_tpu_torch.ops.cuda.regularize import regularize  # noqa: F401  (re-export)
from dvo_tpu_torch.ops.warp import back_project, pixel_grid, project

EPS = 1e-6


def need_new_keyframe(rel_xi, frame_id: int, ref_id: int, cfg: MapperConfig):
    """Translation > min_movement or >= max_forward frames since the
    keyframe (mapper.cpp:45-60).  A device bool scalar."""
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


def epipolar_fields(obj: Scene, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age,
                    history: KeyframeHistory, reset_depth, cfg: MapperConfig):
    """The kernel's 24 per-pixel planes (order of ``ops/cuda/epipolar``)
    and the aged-out count: steps 1-4a and the triangulation coefficients
    of ``dvo_tpu.models.mapper.depth_update``."""
    h, w = ref_depth.shape
    xs, ys = pixel_grid(h, w, device=ref_depth.device)
    xy = torch.stack([xs, ys], dim=-1)
    K = obj.K

    # --- 1. ref pixel -> obj pixel, rounded half to even (mapper.cpp:94) ---
    T_rel = lie.se3_exp(rel_xi)
    warped, in_front = project(K, lie.transform(T_rel, back_project(K, xy, ref_depth)))
    ox = torch.round(warped[..., 0]).to(torch.int32)
    oy = torch.round(warped[..., 1]).to(torch.int32)
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

    # --- 2. born keyframe: relative pose per ring slot, gathered per pixel ---
    slot = born_slot(history, ref_age).long()
    r_xi_slots = lie.compose(obj_xi_w, -history.xi)          # (C, 6)
    T_es_slots = lie.se3_exp(-r_xi_slots)                    # (C, 4, 4)
    r_xi_px = r_xi_slots[slot]
    T_es = T_es_slots[slot]

    # --- 3. prior; 4a. epipolar segment in the born image ---
    prior_d = ref_depth - rel_xi[2]
    prior_s = ref_sigma
    obj_xyf = torch.stack([oxc.to(torch.float32), oyc.to(torch.float32)], dim=-1)
    dmin = torch.clamp(prior_d - prior_s, min=cfg.min_search_depth)
    dmax = prior_d + prior_s

    def es_endpoint(d):
        return project(K, lie.transform(T_es, back_project(K, obj_xyf, d)))

    start, start_front = es_endpoint(dmax)
    end, end_front = es_endpoint(dmin)
    seg = end - start
    length = torch.sqrt(torch.sum(seg * seg, dim=-1) + 1e-20)
    seg_ok = (length > 1e-6) & start_front & end_front & (dmax > dmin)
    direction = seg / length[..., None]

    # --- triangulation coefficients (implement.cpp:49-71) ---
    x_q = back_project(K, obj_xyf, torch.ones_like(prior_d))
    t_tw = -r_xi_px[..., :3]
    R_inv = T_es[..., :3, :3]
    r3_dot_q = torch.sum(R_inv[..., 2, :] * x_q, dim=-1)
    KRq = (K @ (R_inv @ x_q[..., None]))[..., 0]
    Kt = (K @ t_tw[..., None])[..., 0]

    fields = torch.stack(
        [
            start[..., 0], start[..., 1], direction[..., 0], direction[..., 1],
            length, obj_val, slot.to(torch.float32),
            prior_d, prior_s, dmin, dmax,
            r3_dot_q, KRq[..., 0], KRq[..., 1], KRq[..., 2],
            t_tw[..., 2], Kt[..., 0], Kt[..., 1], Kt[..., 2],
            ref_depth, ref_sigma, ref_age.to(torch.float32),
            (pix_ok & seg_ok).to(torch.float32), reset_depth,
        ],
        dim=0,
    )
    return fields, aged_out


def depth_update(obj: Scene, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age,
                 history: KeyframeHistory, reset_depth, cfg: MapperConfig = MapperConfig()):
    """Per-pixel epipolar observation + fusion (Mapper::update,
    mapper.cpp:76-137) over the reference keyframe's base level.
    ``reset_depth`` (H, W) is the reset prior for rejected observations
    (``ops.depth_filter.draw_reset_depth``).
    Returns (depth, sigma, age, DepthUpdateStats)."""
    fields, aged_out = epipolar_fields(obj, obj_xi_w, rel_xi, ref_depth, ref_sigma,
                                       ref_age, history, reset_depth, cfg)
    depth, sigma, age, stats = epipolar.epipolar_update(
        fields, history.gray, history.gx, history.gy, history.gmask, cfg
    )
    return depth, sigma, age.to(ref_age.dtype), DepthUpdateStats(
        observed=stats[0], accepted=stats[1], rejected=stats[2], aged_out=aged_out,
    )
