"""Coarse-to-fine photometric Gauss-Newton tracking — ``dvo_tpu.models.
tracker`` ported (reference tracker.cpp, optimize.cpp).

Each level's GN loop is ``ops.cuda.gn_level``: on a CUDA card one kernel
launch that iterates and stops at convergence on the device; on the CPU the
JAX package's fixed-length masked loop (``early_exit=False``), where every
level takes ``max_iterations`` GN steps and a convergence mask freezes xi
after the reference's post-update break.  Both give the same xi and the same
per-level ``iterations`` as the early-exit ``while_loop`` and read nothing
back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import TrackerConfig
from dvo_tpu_torch.models.frame import Frame, Scene
from dvo_tpu_torch.ops.cuda.gn import gn_terms_plain
from dvo_tpu_torch.ops.cuda.gn_level import gn_level, gn_solve  # noqa: F401 (gn_solve: API)


@dataclasses.dataclass(frozen=True)
class TrackResult:
    xi: torch.Tensor            # (6,) relative pose obj -> ref
    residuals: torch.Tensor     # (levels, iters) mean squared residual per step
    update_norms: torch.Tensor  # (levels, iters)
    valid_counts: torch.Tensor  # (levels, iters) int32
    iterations: torch.Tensor    # (levels,) int32 active steps per level


def gn_terms(obj_gray, obj_mask, ref_depth, ref_sigma,
             ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
             K, xi, level_index: int, cfg: TrackerConfig):
    """Plain-PyTorch normal-equation terms at twist ``xi`` — the
    counterpart of ``dvo_tpu.models.tracker.gn_terms`` (whole image).
    Returns (H (6, 6), g (6,), residual_sum, count)."""
    return gn_terms_plain(obj_gray, obj_mask, ref_depth, ref_sigma,
                          ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask,
                          K, lie.se3_exp(-xi), level_index, cfg)


def level_planes(obj: Scene, ref: Scene):
    """The nine planes a level's linearisation reads, in ``gn_level``'s
    order."""
    return (obj.gray, obj.mask, ref.depth, ref.sigma,
            ref.gray, ref.mask, ref.gx, ref.gy, ref.gmask)


def track_level(obj: Scene, ref: Scene, xi0, level_index: int, cfg: TrackerConfig):
    """One level's GN loop from ``xi0`` (``ops.cuda.gn_level``).
    Returns (xi, (residuals, update_norms, counts, iterations))."""
    xi, res, upd, cnt, iterations = gn_level(level_planes(obj, ref), ref.K, xi0, level_index,
                                             cfg)
    return xi, (res, upd, cnt, iterations)


def track(obj_frame: Frame, ref_frame: Frame, cfg: TrackerConfig = TrackerConfig(),
          xi0: Optional[torch.Tensor] = None) -> TrackResult:
    """Coarsest to finest level, xi carried across levels
    (tracker.cpp:22-84); starts from identity unless ``xi0`` is given."""
    dev = ref_frame.xi.device
    xi = torch.zeros(6, dtype=torch.float32, device=dev) if xi0 is None else xi0
    res_l, upd_l, cnt_l, iters_l = [], [], [], []
    for level in range(len(ref_frame.scenes)):
        xi, (res, upd, cnt, iters) = track_level(
            obj_frame.scenes[level], ref_frame.scenes[level], xi, level, cfg
        )
        res_l.append(res)
        upd_l.append(upd)
        cnt_l.append(cnt)
        iters_l.append(iters)
    return TrackResult(
        xi=xi,
        residuals=torch.stack(res_l),
        update_norms=torch.stack(upd_l),
        valid_counts=torch.stack(cnt_l),
        iterations=torch.stack(iters_l),
    )
