"""The plain reference of windowed photometric bundle adjustment, and of the
monocular step that runs it, in float32 PyTorch.

Written for the benchmark from the equations of the program's windowed BA
(Engel, Koltun, Cremers, "Direct Sparse Odometry", TPAMI 2018, section 3,
on dense semi-dense hosts): it imports nothing of the program.

* Parameters: a right-composed pose increment delta_k in se(3) per
  keyframe of the window (keyframe 0 fixed: the gauge) and one
  inverse-depth increment per host pixel.
* Residual, for every pixel p of host k and every target j != k:
  r = I_j(pi(T_j^-1 T_k X_k(p))) - I_k(p), with X_k(p) the pixel
  back-projected at depth max(d, 1e-3); the pixel counts where the host's
  mask and gradient mask hold, its depth and its depth in j exceed 1e-3,
  the sample lies in j's image, its masked sample is valid and its
  gradient mask samples to 1; Huber weight 1 up to ``huber_delta``,
  ``huber_delta / |r|`` beyond.
* Jacobians, analytic, with g = (gx fx, gy fy) the target's sampled
  gradient and X_j = (x, y, z): dr/dX_j = (g_x / z, g_y / z,
  -(g_x x + g_y y) / z^2); dr/d delta_k = (a, X_k x a) with a = dr/dX_j
  R_jk; dr/d delta_j = (-dr/dX_j, dr/dX_j x X_j); dr/d rho =
  dr/dX_j . (-(X_j - t_jk) / rho).
* Normal equations: camera blocks (6M x 6M), a diagonal depth block, and
  the coupling rows b_p of each pixel.  A pixel's depth belongs to one
  host, so the Schur complement is folded host by host:
  S = sum_k (H_cc,k - sum_p b_p b_p^T / (h_p + depth_damping)), likewise
  the reduced gradient.  S + damping I (+ I on the gauge block) is solved
  by Cholesky; the inverse depths follow by back-substitution,
  d rho_p = -(g_p + b_p . dc) / (h_p + depth_damping).
* ``iterations`` such steps from zero increments; each step's cost (the
  weighted squared residuals at its linearisation point) is kept.

The loops run over hosts and targets one pair at a time; pixels are
tensors.  Every product is float32 unless the caller allows TF32
(``torch.backends.cuda.matmul.allow_tf32``), which the control does.

``mono_step`` is the monocular step with BA in the program's order: track
(or take the tracker's twist), the keyframe decision, then on a promotion
the propagated maps, the ring's refresh and push, BA over the ring's
newest ``window`` keyframes where the ring holds that many, the
write-back into the ring, the new reference with BA's newest pose and
depth, the regulariser.
"""

from __future__ import annotations

import dataclasses

import torch

from vobench.reference import dvo, lie


@dataclasses.dataclass
class Window:
    """M keyframes of the ring (oldest first) at the base level."""
    gray: torch.Tensor    # (M, h, w)
    mask: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    gmask: torch.Tensor
    depth: torch.Tensor
    xi: torch.Tensor      # (M, 6) world poses
    K: torch.Tensor


def slots(ring: dvo.Ring, m: int) -> list:
    """The ring slots of the newest ``m`` keyframes, oldest first (ages past
    the live keyframes clamp to the oldest)."""
    oldest = max(ring.count - 1, 0)
    return [(ring.head - min(age, oldest)) % ring.capacity for age in range(m - 1, -1, -1)]


def window(ring: dvo.Ring, K, m: int) -> Window:
    s = torch.tensor(slots(ring, m), device=ring.gray.device)
    return Window(ring.gray[s], ring.mask[s], ring.gx[s], ring.gy[s], ring.gmask[s],
                  ring.depth[s], ring.xi[s], K)


def _inverse(T):
    R, t = T[:3, :3], T[:3, 3]
    out = torch.zeros_like(T)
    out[:3, :3] = R.T
    out[:3, 3] = -(R.T @ t[:, None])[:, 0]
    out[3, 3] = 1.0
    return out


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def pair(win: Window, T, k: int, j: int, depth, huber: float):
    """Residual, weight and Jacobians of host ``k``'s pixels against target
    ``j`` at poses ``T`` (M, 4, 4) and depths ``depth`` (M, h, w): (r, w,
    Jk (h, w, 6), Jj (h, w, 6), Jrho), gauge and self-pair not applied."""
    h, w_px = win.gray.shape[1:]
    K = win.K
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xs, ys = dvo.pixel_grid(h, w_px, win.gray.device)
    T_jk = _inverse(T[j]) @ T[k]
    R, t = T_jk[:3, :3], T_jk[:3, 3]
    d = depth[k]
    safe_d = torch.clamp(d, min=1e-3)
    rho = 1.0 / safe_d
    Xk = torch.stack([(xs - cx) / fx * safe_d, (ys - cy) / fy * safe_d, safe_d], -1)
    Xj = (Xk @ R.T) + t
    zj = Xj[..., 2]
    z = torch.where(torch.abs(zj) < 1e-6, 1e-6, zj)
    u = fx * Xj[..., 0] / z + cx
    v = fy * Xj[..., 1] / z + cy
    i_j, ok = dvo.bilinear_masked(win.gray[j], win.mask[j], u, v)
    gxv, _ = dvo.bilinear_dense(win.gx[j], u, v)
    gyv, _ = dvo.bilinear_dense(win.gy[j], u, v)
    gm, _ = dvo.bilinear_dense(win.gmask[j].to(torch.float32), u, v)
    r = i_j - win.gray[k]
    valid = (win.mask[k] & (d > 1e-3) & (zj > 1e-3) & ok & (gm > 1.0 - 1e-4)
             & (u >= 0) & (u < w_px) & (v >= 0) & (v < h) & win.gmask[k])
    absr = torch.abs(r)
    weight = torch.where(absr <= huber, 1.0, huber / torch.clamp(absr, min=1e-12)) \
        * valid.to(torch.float32)
    gfx, gfy = gxv * fx, gyv * fy
    dX = torch.stack([gfx / z, gfy / z, -(gfx * Xj[..., 0] + gfy * Xj[..., 1]) / (z * z)], -1)
    a = dX @ R
    Jk = torch.cat([a, _cross(Xk, a)], -1)
    Jj = torch.cat([-dX, _cross(dX, Xj)], -1)
    Jrho = torch.sum(dX * (-(Xj - t) / rho[..., None]), -1)
    return r, weight, Jk, Jj, Jrho


def _depths(win: Window, drho):
    return 1.0 / torch.clamp(1.0 / torch.clamp(win.depth, min=1e-3) + drho, min=1e-4)


def _reduced(win: Window, T, depth, c):
    """The damped reduced system at poses ``T`` and depths ``depth``: (S,
    its gradient, the cost, each host's depth diagonal and depth
    gradient)."""
    m, h, w_px = win.gray.shape
    n = 6 * m
    dev = win.gray.device
    S = torch.zeros((n, n), dtype=torch.float32, device=dev)
    g = torch.zeros(n, dtype=torch.float32, device=dev)
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    hdd_all, gd_all = [], []
    for k in range(m):
        H = torch.zeros((n, n), dtype=torch.float32, device=dev)
        gc = torch.zeros(n, dtype=torch.float32, device=dev)
        B = torch.zeros((h, w_px, n), dtype=torch.float32, device=dev)
        hdd = torch.zeros((h, w_px), dtype=torch.float32, device=dev)
        gd = torch.zeros((h, w_px), dtype=torch.float32, device=dev)
        ck = slice(6 * k, 6 * k + 6)
        for j in range(m):
            if j == k:
                continue
            r, wt, Jk, Jj, Jrho = pair(win, T, k, j, depth, c.huber_delta)
            if k == 0:
                Jk = torch.zeros_like(Jk)
            if j == 0:
                Jj = torch.zeros_like(Jj)
            cj = slice(6 * j, 6 * j + 6)
            Jk2, Jj2 = Jk.reshape(-1, 6), Jj.reshape(-1, 6)
            wv, rv = wt.reshape(-1, 1), r.reshape(-1, 1)
            H[ck, ck] += Jk2.T @ (wv * Jk2)
            H[ck, cj] += Jk2.T @ (wv * Jj2)
            H[cj, ck] += Jj2.T @ (wv * Jk2)
            H[cj, cj] += Jj2.T @ (wv * Jj2)
            gc[ck] += (Jk2.T @ (wv * rv))[:, 0]
            gc[cj] += (Jj2.T @ (wv * rv))[:, 0]
            wJrho = wt * Jrho
            B[..., ck] += Jk * wJrho[..., None]
            B[..., cj] += Jj * wJrho[..., None]
            hdd += wJrho * Jrho
            gd += wJrho * r
            cost += torch.sum(wt * r * r)
        inv = 1.0 / (hdd + c.depth_damping)
        B2 = B.reshape(-1, n)
        S += H - B2.T @ (B2 * inv.reshape(-1, 1))
        g += gc - (B2.T @ (gd * inv).reshape(-1, 1))[:, 0]
        hdd_all.append(hdd)
        gd_all.append(gd)
    S = S + c.damping * torch.eye(n, dtype=torch.float32, device=dev)
    S[:6, :6] += torch.eye(6, dtype=torch.float32, device=dev)
    return S, g, cost, hdd_all, gd_all


def condition(win: Window, c) -> float:
    """The 2-norm condition number of the damped reduced system at the
    window's own poses and depths (the first step's), computed in float64
    from the float32 system."""
    S, _, _, _, _ = _reduced(win, lie.se3_exp(win.xi), _depths(win, torch.zeros_like(win.depth)),
                             c)
    return float(torch.linalg.cond(S.double()))


def step(win: Window, deltas, drho, c):
    """One damped Gauss-Newton step.  ``c``: the BA configuration
    (``window``, ``damping``, ``huber_delta``, ``depth_damping``).  Returns
    (deltas', drho', cost at the linearisation point)."""
    m, h, w_px = win.gray.shape
    dev = win.gray.device
    T = lie.se3_exp(win.xi) @ lie.se3_exp(deltas)
    depth = _depths(win, drho)
    S, g, cost, hdd_all, gd_all = _reduced(win, T, depth, c)
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.nan)
    dc = -torch.cholesky_solve(g[:, None], L)[:, 0]
    # back-substitution: each host's pixels against every target again
    new_drho = torch.empty_like(drho)
    for k in range(m):
        bdot = torch.zeros((h, w_px), dtype=torch.float32, device=dev)
        for j in range(m):
            if j == k:
                continue
            _, wt, Jk, Jj, Jrho = pair(win, T, k, j, depth, c.huber_delta)
            dot = (0.0 if k == 0 else Jk @ dc[6 * k:6 * k + 6]) \
                + (0.0 if j == 0 else Jj @ dc[6 * j:6 * j + 6])
            bdot = bdot + wt * Jrho * dot
        new_drho[k] = drho[k] - (gd_all[k] + bdot) / (hdd_all[k] + c.depth_damping)
    return lie.compose(deltas, dc.reshape(m, 6)), new_drho, cost


def cost(win: Window, xi, depth, c):
    """The weighted photometric cost of the window at poses ``xi`` and
    depths ``depth``: every ordered pair's Huber-weighted squared
    residuals, the cost a step reports at its linearisation point."""
    m = win.gray.shape[0]
    T = lie.se3_exp(xi)
    total = torch.zeros((), dtype=torch.float32, device=win.gray.device)
    for k in range(m):
        for j in range(m):
            if j != k:
                r, wt, _, _, _ = pair(win, T, k, j, depth, c.huber_delta)
                total = total + torch.sum(wt * r * r)
    return total


def bundle_adjust(win: Window, c):
    """``c.iterations`` steps.  Returns (xi (M, 6), depth (M, h, w), costs
    (iterations,))."""
    m, h, w_px = win.gray.shape
    deltas = torch.zeros((m, 6), dtype=torch.float32, device=win.gray.device)
    drho = torch.zeros((m, h, w_px), dtype=torch.float32, device=win.gray.device)
    costs = []
    for _ in range(c.iterations):
        deltas, drho, cost = step(win, deltas, drho, c)
        costs.append(cost)
    xi = lie.se3_log(lie.se3_exp(win.xi) @ lie.se3_exp(deltas))
    return xi, _depths(win, drho), torch.stack(costs)


def write_back(ring: dvo.Ring, m: int, xi, depth) -> dvo.Ring:
    """The ring with the window's poses and depths at its slots."""
    s = torch.tensor(slots(ring, m), device=ring.gray.device)
    new = dataclasses.replace(ring, xi=ring.xi.clone(), depth=ring.depth.clone())
    new.xi[s] = xi
    new.depth[s] = depth
    return new


def mono_step(state: dvo.MonoState, gray, mask, K, cfg, reset_depth, tracked_xi=None,
              solve=None):
    """``dvo.mono_step`` with windowed BA (module docstring).  ``solve(win)``
    -> (xi, depth, costs) stands in for ``bundle_adjust`` where given (the
    judge holds the program's solve against this one there and goes on
    from the program's values).  Returns (state', the dict of
    ``dvo.mono_step`` with ``ba``: (xi, depth, costs) of the solve, or
    None)."""
    pc, tc, mc, bc = cfg.pyramid, cfg.tracker, cfg.mapper, cfg.ba
    frame = dvo.build_frame(gray, mask, K, pc.levels, pc.culls, state.frame_count)
    ref = state.ref
    tracking = None
    if tracked_xi is None:
        tracking = dvo.track(frame, ref, tc, dvo.mono_xi0(state, tc))
        xi = tracking["xi"]
    else:
        xi = tracked_xi
    frame = dataclasses.replace(frame, rel_xi=xi, xi=lie.compose(ref.xi, xi))
    vel = lie.compose(-state.prev_rel, xi)
    kf = bool(dvo.need_new_keyframe(xi, frame.frame_id, ref.frame_id, mc))
    base = ref.base
    solved = None
    if kf:
        d, s, age = dvo.propagate(base.depth, base.sigma, ref.age, frame.rel_xi, base.K, mc,
                                  cfg.init)
        ring = dvo.ring_push(dvo.ring_refresh(state.ring, ref), frame, d, s)
        new_ref, observed = frame, 0
        if ring.count >= bc.window:
            win = window(ring, frame.base.K, bc.window)
            solved = (solve or (lambda w: bundle_adjust(w, bc)))(win)
            ring = write_back(ring, bc.window, solved[0], solved[1])
            d = solved[1][-1]
            new_ref = dataclasses.replace(new_ref, xi=solved[0][-1])
    else:
        d, s, age, observed = dvo.depth_update(frame.base, frame.xi, frame.rel_xi, base.depth,
                                               base.sigma, ref.age, state.ring, reset_depth,
                                               mc)
        ring, new_ref = state.ring, ref
    new_ref = dvo.with_base_maps(new_ref, d, s, age)
    new_ref = dvo.with_base_maps(new_ref, dvo.regularize(new_ref.base.depth,
                                                         new_ref.base.sigma, mc), s, age)
    new_state = dvo.MonoState(ring, new_ref, state.frame_count + 1,
                              torch.zeros_like(xi) if kf else xi, vel)
    return new_state, {"T_world": lie.se3_exp(new_ref.xi if kf else frame.xi), "rel_xi": xi,
                       "is_keyframe": kf, "observed": observed, "tracking": tracking,
                       "ba": solved}
