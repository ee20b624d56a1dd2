"""Keyframe-sharded windowed bundle adjustment — ``dvo_tpu.parallel.ba`` on
``torch.distributed``.

The host keyframes of the BA window shard over the ``kf`` mesh axis.  Every
rank holds the whole window (as ``shard_map`` takes it) and, per iteration:
gathers the inverse-depth increments of every host (the target keyframes'
depths moved too), re-linearises the window, evaluates the photometric pair
terms of its own hosts against every target (``models.ba.host_system``,
targets batched) and sums their Schur-reduced (6M, 6M) contributions; the
system, gradient, cost and count are summed over the axis (one
``all_reduce`` per dtype), the damped Cholesky solve runs replicated, and
each rank back-substitutes its own hosts' inverse depths
(``models.ba.coupling_dot``).  The depths are gathered at the end.

Plain PyTorch on whichever device the window lies, as ``models.ba``: it
reaches no hand-written kernel in ``dvo_tpu`` either.
"""

from __future__ import annotations

import dataclasses

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import BAConfig
from dvo_tpu_torch.models.ba import BAResult, BAWindow, _current_window, coupling_dot, host_system
from dvo_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum, axis_group


def _pad_window(window: BAWindow, m_pad: int) -> BAWindow:
    """Pad with dummy keyframes (all-invalid masks) so the keyframe axis
    divides the mesh.  An all-False mask zeroes every pair term the dummy
    touches as host (valid &= mask[k]) and as target (the sample's mask),
    so padded entries contribute exactly nothing; their pose blocks are held
    by the Levenberg ridge and their increments are discarded on
    slice-back."""
    def pad(arr):
        return torch.cat([arr, arr[-1:].expand((m_pad,) + arr.shape[1:])])

    def no(arr):
        return torch.cat([arr, torch.zeros((m_pad,) + arr.shape[1:], dtype=torch.bool,
                                           device=arr.device)])

    return dataclasses.replace(
        window, gray=pad(window.gray), mask=no(window.mask), gx=pad(window.gx),
        gy=pad(window.gy), gmask=no(window.gmask), depth=pad(window.depth),
        sigma=pad(window.sigma), xi=pad(window.xi))


def bundle_adjust_sharded(window: BAWindow, cfg: BAConfig, mesh, axis: str = "kf") -> BAResult:
    """Distributed ``models.ba.bundle_adjust``: the same math, host
    keyframes sharded over ``axis``.  Windows that the axis does not divide
    are padded with inert dummy keyframes (``_pad_window``), so the
    north-star window of 7 runs on any mesh.  Every rank returns the whole
    result."""
    m_true, h, w_px = window.gray.shape
    rank, n_dev, group = axis_group(mesh, axis)
    if m_true % n_dev:
        window = _pad_window(window, n_dev - m_true % n_dev)
    m = window.size
    m_loc = m // n_dev
    n = 6 * m
    hosts = range(rank * m_loc, (rank + 1) * m_loc)
    f32 = dict(dtype=torch.float32, device=window.gray.device)
    eye = torch.eye(n, **f32)

    deltas = torch.zeros((m, 6), **f32)
    drho_loc = torch.zeros((m_loc, h, w_px), **f32)
    costs, counts = [], []
    for _ in range(cfg.iterations):
        # Every host's pair terms read its targets' depths: gather the
        # inverse-depth increments of all hosts.
        (drho_all,) = all_gather_rows([drho_loc], group)
        win_cur, T_all = _current_window(window, deltas, drho_all)
        S = torch.zeros((n, n), **f32)
        g_red = torch.zeros((n,), **f32)
        cost = torch.zeros((), **f32)
        count = torch.zeros((), dtype=torch.int32, device=window.gray.device)
        hdd, gd = [], []
        for k in hosts:
            Sk, gk, hddk, gdk, ck, nk = host_system(win_cur, T_all, k, cfg)
            S, g_red, cost, count = S + Sk, g_red + gk, cost + ck, count + nk
            hdd.append(hddk)
            gd.append(gdk)
        S, g_red, cost, count = all_reduce_sum([S, g_red, cost, count], group)

        S = S + cfg.damping * eye
        S[:6, :6] += eye[:6, :6]
        L, info = torch.linalg.cholesky_ex(S, check_errors=False)
        L = torch.where(info == 0, L, torch.nan)
        dc = -torch.cholesky_solve(g_red[:, None], L)[:, 0]
        # Back-substitution: each local host's coupling dot against the
        # replicated dc, recomputed from its pair terms.
        hdd_inv = 1.0 / (torch.stack(hdd) + cfg.depth_damping)
        bdot = torch.stack([coupling_dot(win_cur, T_all, k, dc, cfg) for k in hosts])
        drho_loc = drho_loc - (torch.stack(gd) + bdot) * hdd_inv
        deltas = lie.compose(deltas, dc.reshape(m, 6))
        costs.append(cost)
        counts.append(count)

    xi = lie.se3_log(lie.se3_exp(window.xi) @ lie.se3_exp(deltas))
    safe_d = torch.clamp(window.depth[rank * m_loc:(rank + 1) * m_loc], min=1e-3)
    (depth,) = all_gather_rows([1.0 / torch.clamp(1.0 / safe_d + drho_loc, min=1e-4)], group)
    # Slice the padding back off (inert dummy keyframes, see _pad_window).
    return BAResult(xi=xi[:m_true], depth=depth[:m_true], costs=torch.stack(costs),
                    counts=torch.stack(counts))
