"""Windowed photometric bundle adjustment with Schur-complement depth
elimination — ``dvo_tpu.models.ba`` ported (no reference counterpart).

Jointly refines the camera poses and per-pixel inverse depths of an
M-keyframe window by minimising Huber-weighted photometric residuals over
all ordered keyframe pairs:

  * Parameters: right-composed pose increments delta_k in se(3) per keyframe
    (keyframe 0 gauge-fixed) and one inverse-depth increment per host pixel.
  * Residual r_kj(p) = I_j(pi(T_j^-1 T_k backproj(p, 1/rho))) - I_k(p) for
    every pixel p of host keyframe k and target j != k, masked to valid and
    visible pixels.
  * Jacobians are analytic (the tracker's chain extended with the target
    pose and inverse-depth terms) and dense.
  * Normal system: camera block H_cc (6M x 6M), diagonal depth block H_dd,
    coupling H_cd.  A pixel's depth couples only its own host's residuals,
    so the Schur complement S = H_cc - H_cd H_dd^-1 H_dc separates per
    host: each host accumulates its coupling rows (H, W, 6M), folds them
    into its (6M, 6M) contribution and drops them; nothing of size
    (M, H, W, 6M) exists at once.  The reduced system is solved by Cholesky;
    the inverse-depth back-substitution recomputes the coupling dot in a
    second pass over the pair terms.

Plain PyTorch on tensors, on whichever device the window lies: it reaches
no hand-written kernel in ``dvo_tpu`` either.  Where the JAX package scans
over the targets of a host (its compile time was quadratic when unrolled),
the port by default evaluates all targets of a host in one batched
``_pair_terms`` (tensors (M, H, W, ...)): eager PyTorch pays host time per
operation, not per element.  The sums over targets then run in a tree
inside ``einsum``/``sum`` instead of the scan's sequence; ``batch_targets=
False`` keeps the literal double loop (tests hold the two together at 1e-5
relative on the system; the ill-conditioned solve amplifies that to 3e-5 on
one step's twists).

Precision: every contraction is a float32 product.  Importing this module
turns TF32 matmuls off (``torch.backends.cuda.matmul.allow_tf32 = False``,
PyTorch's default), as ``dvo_tpu`` asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import BAConfig
from dvo_tpu_torch.ops.sampling import bilinear_dense, bilinear_masked
from dvo_tpu_torch.ops.warp import pixel_grid

torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class BAWindow:
    """M stacked keyframes (base pyramid level), oldest first."""

    gray: torch.Tensor    # (M, H, W)
    mask: torch.Tensor    # (M, H, W) bool
    gx: torch.Tensor      # (M, H, W)
    gy: torch.Tensor      # (M, H, W)
    gmask: torch.Tensor   # (M, H, W) bool
    depth: torch.Tensor   # (M, H, W)
    sigma: torch.Tensor   # (M, H, W)
    xi: torch.Tensor      # (M, 6) world pose twists (camera to world)
    K: torch.Tensor       # (3, 3)

    @property
    def size(self) -> int:
        return self.gray.shape[0]


def window_from_reference(obj, device) -> BAWindow:
    """The port's ``BAWindow`` on ``device`` from a ``dvo_tpu`` BAWindow with
    numpy leaves (attributes only)."""
    return BAWindow(**{f.name: torch.tensor(np.asarray(getattr(obj, f.name)), device=device)
                       for f in dataclasses.fields(BAWindow)})


def window_slots(history, m: int) -> torch.Tensor:
    """Ring slots of the newest ``m`` keyframes, oldest first: an (m,) int64
    tensor on the ring's device, computed there from its ``head`` and
    ``count`` (no host read).  The index map shared by
    ``window_from_history`` and the write-back.  Ages beyond the live window
    clamp to the oldest retained keyframe, as ``born_slot``."""
    ages = torch.arange(m - 1, -1, -1, device=history.head.device)
    oldest = torch.clamp(history.count - 1, min=0)
    return torch.remainder(history.head - torch.minimum(ages, oldest), history.capacity)


def window_from_history(history, K, m: int, slots=None) -> BAWindow:
    """The newest ``m`` keyframes of the ring (oldest first) as a dense
    window, gathered on the device: one ``index_select`` per plane kind at
    ``slots`` (default: ``window_slots(history, m)``)."""
    slots = window_slots(history, m) if slots is None else slots
    take = lambda arr: torch.index_select(arr, 0, slots)
    return BAWindow(
        gray=take(history.gray), mask=take(history.mask),
        gx=take(history.gx), gy=take(history.gy), gmask=take(history.gmask),
        depth=take(history.depth), sigma=take(history.sigma),
        xi=take(history.xi), K=K,
    )


def _pair_terms(window: BAWindow, T_all, k: int, j, cfg: BAConfig):
    """Dense residual and Jacobian terms of host keyframe ``k`` against
    target ``j`` (an int), or against every target at once (``j=None``).

    Returns (r, w, Jk (..., 6), Jj (..., 6), Jrho) over k's pixels: (H, W)
    leading shape for one target, (M, H, W) for all.
    """
    m, h, w_px = window.gray.shape
    K = window.K
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs, ys = pixel_grid(h, w_px, device=window.gray.device)
    js = slice(None) if j is None else slice(j, j + 1)

    # Relative transform camera_k -> camera_j: T_jk = T_j^-1 T_k.
    T_jk = lie.invert_T(T_all[js]) @ T_all[k]
    R_jk = T_jk[:, :3, :3]
    t_jk = T_jk[:, None, None, :3, 3]

    depth = window.depth[k]
    safe_d = torch.clamp(depth, min=1e-3)
    rho = 1.0 / safe_d

    # Host camera point and its image in camera j.
    xn = (xs - cx) / fx
    yn = (ys - cy) / fy
    Xk = torch.stack([xn * safe_d, yn * safe_d, safe_d], dim=-1)
    Xj = torch.einsum("jab,hwb->jhwa", R_jk, Xk) + t_jk
    zj = Xj[..., 2]
    safe_z = torch.where(torch.abs(zj) < 1e-6, 1e-6, zj)
    u = fx * Xj[..., 0] / safe_z + cx
    v = fy * Xj[..., 1] / safe_z + cy

    # Samples from the target keyframes.
    i_j, samp_ok = bilinear_masked(window.gray[js], window.mask[js], u, v)
    gxv, _ = bilinear_dense(window.gx[js], u, v)
    gyv, _ = bilinear_dense(window.gy[js], u, v)
    gmask_f, _ = bilinear_dense(window.gmask[js].to(torch.float32), u, v)

    r = i_j - window.gray[k]

    valid = window.mask[k] & (depth > 1e-3) & (zj > 1e-3)
    valid = valid & samp_ok & (gmask_f > 1.0 - 1e-4)
    valid = valid & (u >= 0) & (u < w_px) & (v >= 0) & (v < h)
    # Semi-dense host selection: only pixels with a usable host gradient
    # carry depth information.
    valid = valid & window.gmask[k]

    absr = torch.abs(r)
    w_huber = torch.where(absr <= cfg.huber_delta, 1.0,
                          cfg.huber_delta / torch.clamp(absr, min=1e-12))
    w_all = w_huber * valid.to(torch.float32)

    # dr/dXj = [gfx/z, gfy/z, -(gfx*x + gfy*y)/z^2]
    gfx = gxv * fx
    gfy = gyv * fy
    dr_dXj = torch.stack(
        [gfx / safe_z, gfy / safe_z,
         -(gfx * Xj[..., 0] + gfy * Xj[..., 1]) / (safe_z * safe_z)], dim=-1)

    # d Xj / d delta_k = R_jk [I | -hat(Xk)] (right increment on T_k):
    #   dr/dv_k = dr_dXj R_jk =: a,  dr/dw_k = Xk x a
    a = torch.einsum("jhwa,jab->jhwb", dr_dXj, R_jk)
    Jk = torch.cat([a, torch.linalg.cross(Xk.expand_as(a), a, dim=-1)], dim=-1)
    # d Xj / d delta_j = [-I | hat(Xj)]:
    #   dr/dv_j = -dr_dXj,  dr/dw_j = dr_dXj x Xj
    Jj = torch.cat([-dr_dXj, torch.linalg.cross(dr_dXj, Xj, dim=-1)], dim=-1)
    # d Xj / d rho = R_jk dXk/drho = -(Xj - t_jk) / rho
    dXj_drho = -(Xj - t_jk) / rho[..., None]
    Jrho = torch.sum(dr_dXj * dXj_drho, dim=-1)

    out = (r, w_all, Jk, Jj, Jrho)
    return out if j is None else tuple(t[0] for t in out)


def _current_window(window: BAWindow, deltas, drho):
    """The window re-linearised at the current increments: poses
    right-composed with ``deltas``, depths moved by the inverse-depth
    increments.  Returns (window', T_all (M, 4, 4))."""
    T_all = lie.se3_exp(window.xi) @ lie.se3_exp(deltas)
    safe_d = torch.clamp(window.depth, min=1e-3)
    new_depth = 1.0 / torch.clamp(1.0 / safe_d + drho, min=1e-4)
    return dataclasses.replace(window, depth=new_depth), T_all


def _gated_pair_terms(window: BAWindow, T_all, k: int, j, cfg: BAConfig):
    """Pair terms with the self-pair and gauge gates applied (keyframe 0's
    pose is fixed; k == j contributes nothing).  The gates multiply, as in
    ``dvo_tpu``, so a non-finite term stays non-finite."""
    r, w_all, Jk, Jj, Jrho = _pair_terms(window, T_all, k, j, cfg)
    Jk = Jk * (0.0 if k == 0 else 1.0)                        # gauge host
    if j is not None:
        return (r, w_all * (0.0 if j == k else 1.0), Jk,
                Jj * (0.0 if j == 0 else 1.0), Jrho)
    not_self = torch.ones(window.size, dtype=torch.float32, device=r.device)
    not_self[k].zero_()                                       # skip self-pair
    not_gauge = torch.ones_like(not_self)
    not_gauge[0].zero_()                                      # gauge target
    return (r, w_all * not_self[:, None, None], Jk,
            Jj * not_gauge[:, None, None, None], Jrho)


def _host_sums_batched(window, T_all, k, cfg):
    """(Hblk (M, M, 6, 6), gc (M, 6), b_host (H, W, M, 6), hdd, gd, cost,
    count) of host ``k`` from one batched evaluation of all its targets."""
    m = window.size
    r, w_all, Jk, Jj, Jrho = _gated_pair_terms(window, T_all, k, None, cfg)
    wJk = Jk * w_all[..., None]
    wJj = Jj * w_all[..., None]
    Hkj = torch.einsum("jhwa,jhwb->jab", wJk, Jj)
    Hblk = torch.zeros((m, m, 6, 6), dtype=torch.float32, device=r.device)
    Hblk[k] += Hkj
    Hblk[:, k] += Hkj.transpose(-1, -2)
    Hblk.diagonal(dim1=0, dim2=1).add_(
        torch.einsum("jhwa,jhwb->jab", wJj, Jj).permute(1, 2, 0))
    Hblk[k, k] += torch.einsum("jhwa,jhwb->ab", wJk, Jk)
    gc = torch.einsum("jhwa,jhw->ja", wJj, r)
    gc[k] += torch.einsum("jhwa,jhw->a", wJk, r)
    # Coupling rows: block j from target j, block k summed over targets.
    wJrho = w_all * Jrho
    b_host = (Jj * wJrho[..., None]).permute(1, 2, 0, 3).contiguous()
    b_host[:, :, k] += torch.sum(Jk * wJrho[..., None], dim=0)
    hdd = torch.sum(wJrho * Jrho, dim=0)
    gd = torch.sum(wJrho * r, dim=0)
    cost = torch.sum(w_all * r * r)
    count = torch.sum(w_all > 0).to(torch.int32)
    return Hblk, gc, b_host, hdd, gd, cost, count


def _host_sums_loop(window, T_all, k, cfg):
    """``_host_sums_batched`` as ``dvo_tpu``'s scan computes it: one target
    at a time, accumulated in target order."""
    m, h, w_px = window.gray.shape
    f32 = dict(dtype=torch.float32, device=window.gray.device)
    Hblk = torch.zeros((m, m, 6, 6), **f32)
    gc = torch.zeros((m, 6), **f32)
    b_host = torch.zeros((h, w_px, m, 6), **f32)
    hdd = torch.zeros((h, w_px), **f32)
    gd = torch.zeros((h, w_px), **f32)
    cost = torch.zeros((), **f32)
    count = torch.zeros((), dtype=torch.int32, device=window.gray.device)
    for j in range(m):
        r, w_all, Jk, Jj, Jrho = _gated_pair_terms(window, T_all, k, j, cfg)
        wJk = Jk * w_all[..., None]
        wJj = Jj * w_all[..., None]
        Hkj = torch.einsum("hwi,hwj->ij", wJk, Jj)
        Hblk[k, k] += torch.einsum("hwi,hwj->ij", wJk, Jk)
        Hblk[k, j] += Hkj
        Hblk[j, k] += Hkj.T
        Hblk[j, j] += torch.einsum("hwi,hwj->ij", wJj, Jj)
        gc[k] += torch.einsum("hwi,hw->i", wJk, r)
        gc[j] += torch.einsum("hwi,hw->i", wJj, r)
        wJrho = w_all * Jrho
        b_host[:, :, k] += Jk * wJrho[..., None]
        b_host[:, :, j] += Jj * wJrho[..., None]
        hdd = hdd + wJrho * Jrho
        gd = gd + wJrho * r
        cost = cost + torch.sum(w_all * r * r)
        count = count + torch.sum(w_all > 0).to(torch.int32)
    return Hblk, gc, b_host, hdd, gd, cost, count


def host_system(window: BAWindow, T_all, k: int, cfg: BAConfig, batch_targets: bool = True):
    """Schur-reduced normal-system contribution of host keyframe ``k`` (its
    pixels against every target j != k).  Every pixel's inverse depth
    belongs to exactly one host, so its elimination completes here: the
    coupling rows (H, W, 6M) live for this call only.

    Returns (S_k (6M, 6M), g_k (6M,), hdd (H, W), gd (H, W), cost, count)."""
    m, h, w_px = window.gray.shape
    n = 6 * m
    sums = _host_sums_batched if batch_targets else _host_sums_loop
    Hblk, gc, b_host, hdd, gd, cost, count = sums(window, T_all, k, cfg)
    Hcc = Hblk.permute(0, 2, 1, 3).reshape(n, n)
    b_host = b_host.reshape(h, w_px, n)
    hdd_inv = 1.0 / (hdd + cfg.depth_damping)
    S_k = Hcc - torch.einsum("hwi,hwj,hw->ij", b_host, b_host, hdd_inv)
    g_k = gc.reshape(n) - torch.einsum("hwi,hw,hw->i", b_host, gd, hdd_inv)
    return S_k, g_k, hdd, gd, cost, count


def coupling_dot(window: BAWindow, T_all, k: int, dc, cfg: BAConfig,
                 batch_targets: bool = True):
    """Per-pixel coupling dot b_p . dc of host keyframe ``k``, recomputed
    from the pair terms (the rows are never kept across hosts).  ``dc`` is
    the solved (6M,) camera increment.  Returns (H, W)."""
    m = window.size
    dc_m = dc.reshape(m, 6)
    if batch_targets:
        _, w_all, Jk, Jj, Jrho = _gated_pair_terms(window, T_all, k, None, cfg)
        dot = (torch.einsum("jhwi,i->jhw", Jk, dc_m[k])
               + torch.einsum("jhwi,ji->jhw", Jj, dc_m))
        return torch.sum(w_all * Jrho * dot, dim=0)
    bdot = torch.zeros(window.gray.shape[1:], dtype=torch.float32, device=dc.device)
    for j in range(m):
        _, w_all, Jk, Jj, Jrho = _gated_pair_terms(window, T_all, k, j, cfg)
        dot = torch.einsum("hwi,i->hw", Jk, dc_m[k]) + torch.einsum("hwi,i->hw", Jj, dc_m[j])
        bdot = bdot + w_all * Jrho * dot
    return bdot


def _accumulate(window_cur, T_all, cfg, batch_targets):
    """The host loop of ``build_system`` on an already re-linearised
    window."""
    n = 6 * window_cur.size
    f32 = dict(dtype=torch.float32, device=window_cur.gray.device)
    S = torch.zeros((n, n), **f32)
    g_red = torch.zeros((n,), **f32)
    cost = torch.zeros((), **f32)
    count = torch.zeros((), dtype=torch.int32, device=window_cur.gray.device)
    hdd, gd = [], []
    for k in range(window_cur.size):
        Sk, gk, hddk, gdk, ck, nk = host_system(window_cur, T_all, k, cfg, batch_targets)
        S, g_red, cost, count = S + Sk, g_red + gk, cost + ck, count + nk
        hdd.append(hddk)
        gd.append(gdk)
    return S, g_red, torch.stack(hdd), torch.stack(gd), cost, count


def build_system(window: BAWindow, deltas, drho, cfg: BAConfig, batch_targets: bool = True):
    """The Schur-reduced system at the current increments.  Returns
    (S (6M, 6M), g_red (6M,), hdd (M, H, W), gd (M, H, W), cost, count).
    Peak memory is one host's coupling rows (H, W, 6M)."""
    window_cur, T_all = _current_window(window, deltas, drho)
    return _accumulate(window_cur, T_all, cfg, batch_targets)


def ba_step(window: BAWindow, deltas, drho, cfg: BAConfig, batch_targets: bool = True):
    """One damped GN step with Schur elimination of the depth block.
    Returns (new_deltas, new_drho, cost, count).  A factorisation that
    fails yields NaNs, as ``dvo_tpu``'s does, through a ``where`` on the
    device: nothing is read on the host."""
    m = window.size
    n = 6 * m
    win_cur, T_all = _current_window(window, deltas, drho)
    S, g_red, hdd, gd, cost, count = _accumulate(win_cur, T_all, cfg, batch_targets)

    S = S + cfg.damping * torch.eye(n, dtype=S.dtype, device=S.device)
    # Gauge block: keyframe 0 stays pinned through identity rows.
    S[:6, :6] += torch.eye(6, dtype=S.dtype, device=S.device)
    # With dr/ddelta = J the GN step is delta = -S^-1 g: L L^T dc = -g by
    # two triangular solves (cuSOLVER's potrs cannot be captured into a
    # CUDA graph's conditional body; a triangular solve can).
    L, info = torch.linalg.cholesky_ex(S, check_errors=False)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.linalg.solve_triangular(L, g_red[:, None], upper=False)
    dc = -torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    # Back-substitute the inverse-depth increments; the coupling dot is
    # recomputed per host instead of kept.
    hdd_inv = 1.0 / (hdd + cfg.depth_damping)
    bdot = torch.stack([coupling_dot(win_cur, T_all, k, dc, cfg, batch_targets)
                        for k in range(m)])
    d_drho = -(gd + bdot) * hdd_inv

    new_deltas = lie.compose(deltas, dc.reshape(m, 6))
    return new_deltas, drho + d_drho, cost, count


@dataclasses.dataclass(frozen=True)
class BAResult:
    xi: torch.Tensor       # (M, 6) refined world pose twists
    depth: torch.Tensor    # (M, H, W) refined depths
    costs: torch.Tensor    # (iters,) weighted photometric cost per iteration
    counts: torch.Tensor   # (iters,) int32 active residuals


def bundle_adjust(window: BAWindow, cfg: BAConfig = BAConfig(),
                  batch_targets: bool = True) -> BAResult:
    """``cfg.iterations`` damped GN steps on ``window``, on its device."""
    m, h, w_px = window.gray.shape
    dev = window.gray.device
    deltas = torch.zeros((m, 6), dtype=torch.float32, device=dev)
    drho = torch.zeros((m, h, w_px), dtype=torch.float32, device=dev)
    costs, counts = [], []
    for _ in range(cfg.iterations):
        deltas, drho, cost, count = ba_step(window, deltas, drho, cfg, batch_targets)
        costs.append(cost)
        counts.append(count)
    xi = lie.se3_log(lie.se3_exp(window.xi) @ lie.se3_exp(deltas))
    safe_d = torch.clamp(window.depth, min=1e-3)
    depth = 1.0 / torch.clamp(1.0 / safe_d + drho, min=1e-4)
    return BAResult(xi=xi, depth=depth, costs=torch.stack(costs), counts=torch.stack(counts))
