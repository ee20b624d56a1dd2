"""Coarse-to-fine photometric Gauss-Newton tracking — ``dvo_tpu.models.
tracker`` ported (reference tracker.cpp, optimize.cpp).

The port runs the JAX package's fixed-length masked driver
(``early_exit=False``): every level takes ``max_iterations`` GN steps and a
convergence mask freezes xi after the reference's post-update break.  It
gives the same xi and the same per-level ``iterations`` as the early-exit
``while_loop`` and reads nothing back to the host, where an early exit
would cost one device sync per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import TrackerConfig
from dvo_tpu_torch.models.frame import Frame, Scene
from dvo_tpu_torch.ops.cuda.gn import gn_terms as gn_terms_kernel
from dvo_tpu_torch.ops.cuda.gn import gn_terms_plain


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


def gn_solve(Hmat, g, count, damping: float):
    """delta = (H + lambda I)^-1 g, zero when no pixel was valid
    (optimize.cpp:93-94).  ``cholesky_ex`` reports failure in ``info``
    instead of syncing to raise; a failed factorisation gives NaN, as JAX's
    does, so the caller's finiteness guard keeps the previous xi."""
    A = Hmat + damping * torch.eye(6, dtype=Hmat.dtype, device=Hmat.device)
    L, info = torch.linalg.cholesky_ex(A)
    delta = torch.cholesky_solve(g[:, None], L)[:, 0]
    delta = torch.where(info == 0, delta, torch.nan)
    return torch.where(count > 0, delta, 0.0)


def _gn_iteration(obj: Scene, ref: Scene, xi, level_index: int, cfg: TrackerConfig):
    """One linearise-solve-compose step.
    Returns (new_xi, mean_res, update_norm, count, converged)."""
    Hmat, g, rsum, count = gn_terms_kernel(
        obj.gray, obj.mask, ref.depth, ref.sigma,
        ref.gray, ref.mask, ref.gx, ref.gy, ref.gmask,
        ref.K, lie.se3_exp(-xi), level_index, cfg,
    )
    delta = gn_solve(Hmat, g, count, cfg.damping)
    new_xi = lie.compose(xi, delta)
    # NaN guard: keep the previous xi on a bad update (tracker.cpp:47-51).
    new_xi = torch.where(lie.is_finite_xi(new_xi), new_xi, xi)
    mean_res = torch.where(count > 0, rsum / torch.clamp(count, min=1), -1.0)
    upd = torch.linalg.vector_norm(delta)
    # Evaluated after the update, as the reference's break (tracker.cpp:68-73).
    converged = (upd < cfg.min_update_norm) | (mean_res < cfg.min_residual) | (count == 0)
    return new_xi, mean_res, upd, count, converged


def track_level(obj: Scene, ref: Scene, xi0, level_index: int, cfg: TrackerConfig):
    """``max_iterations`` masked GN steps at one level.
    Returns (xi, (residuals, update_norms, counts, iterations))."""
    xi = xi0
    done = torch.zeros((), dtype=torch.bool, device=xi0.device)
    res, upd, cnt, active = [], [], [], []
    for _ in range(cfg.max_iterations):
        new_xi, mean_res, u, count, converged = _gn_iteration(obj, ref, xi, level_index, cfg)
        xi = torch.where(done, xi, new_xi)
        res.append(torch.where(done, 0.0, mean_res))
        upd.append(torch.where(done, 0.0, u))
        cnt.append(torch.where(done, 0, count))
        active.append(~done)
        done = done | converged
    iterations = torch.stack(active).sum().to(torch.int32)
    return xi, (torch.stack(res), torch.stack(upd), torch.stack(cnt), iterations)


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
