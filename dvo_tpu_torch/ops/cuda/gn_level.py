"""One pyramid level of Gauss-Newton tracking: the CUDA kernel
``csrc/gn_level.cu`` (the level's whole GN loop in one launch), its plain
PyTorch version, and the wrapper that picks one by device.

Replaces ``dvo_tpu/ops/pallas/gn.py:_gn_kernel`` together with the loop the
JAX package compiles around it (``dvo_tpu.models.tracker.track_level``).
The kernel's header note says what bounds it on the card and what its
design does about that.

``gn_level_plain`` is the fixed-length masked loop written once over a
terms function: with ``gn_terms_plain`` it is the plain version (the CPU
path, and what the kernel is held against on the card); with the
``gn.gn_terms`` wrapper it is the stepwise loop, one ``csrc/gn.cu`` launch
per iteration, the kernel's yardstick on the card.

``step_launcher`` wraps the other half of a step, ``csrc/gn.cu``'s step
kernel: the solve and pose update from a linearisation's (all-reduced) 29
sums, the tile-sharded tracker's step after its collective
(``parallel.tracking``).  Its plain version is ``gn_step_plain``, the
post-terms half of ``gn_iteration``; ``step_plain`` applies it to the
kernel's buffers.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import TrackerConfig, resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.cuda.gn import (
    BYTES_PER_PIXEL,
    FLOPS_PER_PIXEL,
    FLOPS_PER_VALID_PIXEL,
    N_SUMS,
    PLANE_NAMES,
    _level_step,
    gn_terms_plain,
    unpack_sums,
)

# The kernel keeps the lower triangle of H only, as gn.cu does.
LEVEL_FLOPS_PER_VALID_PIXEL = FLOPS_PER_VALID_PIXEL
# One step's solve and pose update, counted from the kernel's epilogue: the
# Cholesky factorisation and the two substitutions (~200), three se3_exp, one
# se3_log and the 3x3 products between them (~500).
EPILOGUE_FLOPS = 700


def work(shape, valid_counts, max_iterations: int):
    """(bytes, float operations) of one call at ``shape`` = (h, w) whose
    active steps found ``valid_counts`` valid pixels (one entry per active
    step): every input plane read once and every output written once,
    whatever the number of steps; the operations of the steps that ran."""
    n = shape[0] * shape[1]
    outputs = (6 + 2 * max_iterations) * 4 + (max_iterations + 1) * 4
    nbytes = BYTES_PER_PIXEL * n + (9 + 6) * 4 + outputs
    flops = sum(FLOPS_PER_PIXEL * n + LEVEL_FLOPS_PER_VALID_PIXEL * int(v) + EPILOGUE_FLOPS
                for v in valid_counts)
    return nbytes, flops


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


def gn_step_plain(Hmat, g, rsum, count, xi, cfg: TrackerConfig):
    """One GN step at ``xi`` from a linearisation's terms: the solve, the
    pose update, the NaN guard and the convergence test — the plain version
    of the step kernel (``csrc/gn.cu``, ``csrc/gn_step.cuh``).
    Returns (new_xi, mean_res, update_norm, converged)."""
    delta = gn_solve(Hmat, g, count, cfg.damping)
    new_xi = lie.compose(xi, delta)
    # NaN guard: keep the previous xi on a bad update (tracker.cpp:47-51).
    new_xi = torch.where(lie.is_finite_xi(new_xi), new_xi, xi)
    mean_res = torch.where(count > 0, rsum / torch.clamp(count, min=1), -1.0)
    upd = torch.linalg.vector_norm(delta)
    # Evaluated after the update, as the reference's break (tracker.cpp:68-73).
    converged = (upd < cfg.min_update_norm) | (mean_res < cfg.min_residual) | (count == 0)
    return new_xi, mean_res, upd, converged


def gn_iteration(planes, K, xi, level_index: int, cfg: TrackerConfig, terms=gn_terms_plain):
    """One linearise-solve-compose step over ``planes`` (obj gray, obj mask,
    ref depth, sigma, gray, mask, gx, gy, gmask).
    Returns (new_xi, mean_res, update_norm, count, converged)."""
    Hmat, g, rsum, count = terms(*planes, K, lie.se3_exp(-xi), level_index, cfg)
    new_xi, mean_res, upd, converged = gn_step_plain(Hmat, g, rsum, count, xi, cfg)
    return new_xi, mean_res, upd, count, converged


def gn_level_plain(planes, K, xi0, level_index: int, cfg: TrackerConfig, terms=gn_terms_plain):
    """``max_iterations`` masked GN steps at one level: a convergence mask
    freezes xi after the reference's post-update break, and the statistics
    of the steps after it are 0.  Nothing is read back to the host.
    Returns (xi (6,), residuals (n,), update_norms (n,), valid_counts (n,)
    int32, iterations () int32)."""
    xi = xi0
    done = torch.zeros((), dtype=torch.bool, device=xi0.device)
    res, upd, cnt, active = [], [], [], []
    for _ in range(cfg.max_iterations):
        new_xi, mean_res, u, count, converged = gn_iteration(planes, K, xi, level_index, cfg,
                                                            terms)
        xi = torch.where(done, xi, new_xi)
        res.append(torch.where(done, 0.0, mean_res))
        upd.append(torch.where(done, 0.0, u))
        cnt.append(torch.where(done, 0, count))
        active.append(~done)
        done = done | converged
    iterations = torch.stack(active).sum().to(torch.int32)
    return xi, torch.stack(res), torch.stack(upd), torch.stack(cnt), iterations


def gn_level(planes, K, xi0, level_index: int, cfg: TrackerConfig):
    """``gn_level_plain`` for CPU tensors; one ``csrc/gn_level.cu`` launch
    for CUDA tensors (it launches or raises, and never synchronises)."""
    obj_gray = planes[0]
    if resolve_device(obj_gray) == "plain":
        return gn_level_plain(planes, K, xi0, level_index, cfg)
    h, w = obj_gray.shape
    dev = obj_gray.device
    f32, i32, u8 = torch.float32, torch.int32, torch.bool
    if len(planes) != len(PLANE_NAMES):
        raise ValueError(f"{len(planes)} planes, expected {len(PLANE_NAMES)}")
    for name, t in zip(PLANE_NAMES, planes):
        _build.require(t, name, u8 if name.endswith("mask") else f32, (h, w), dev)
    _build.require(K, "K", f32, (3, 3), dev)
    _build.require(xi0, "xi0", f32, (6,), dev)
    n = cfg.max_iterations
    if n < 1:
        raise ValueError(f"max_iterations={n}")

    lib = _build.library()
    floats = torch.empty(6 + 2 * n, dtype=f32, device=dev)
    ints = torch.empty(n + 1, dtype=i32, device=dev)
    xi, res, upd = floats[:6], floats[6:6 + n], floats[6 + n:]
    cnt, iterations = ints[:n], ints[n]
    crop = level_index == cfg.crop_level
    code = lib.dvo_gn_level(
        *(t.data_ptr() for t in planes), K.data_ptr(), xi0.data_ptr(),
        xi.data_ptr(), res.data_ptr(), upd.data_ptr(), cnt.data_ptr(), iterations.data_ptr(),
        None,  # no clock stamps (tools/gn_level_stamps.py)
        h, w, _level_step(cfg, level_index), cfg.min_depth,
        cfg.sigma_clamp[0], cfg.sigma_clamp[1], int(cfg.compat_weight_b_only),
        int(crop), cfg.crop_x[0], cfg.crop_x[1], cfg.crop_y[0], cfg.crop_y[1],
        n, cfg.damping, cfg.min_update_norm, cfg.min_residual,
        _build.stream_handle(dev),
    )
    _build.check(code, "gn_level")
    _build.LAUNCHES["gn_level"] += 1
    return xi, res, upd, cnt, iterations


# The step kernel's state: T_inv rows 0-2 (12) | xi (6) | done (1.0 or 0.0).
STATE = 19
# step(SEED) writes a level's first state from its xi0.
SEED = -1


def step_work():
    """(bytes, float operations) of one step of the step kernel: the 29
    sums and the state's xi and done read, the state and three statistics
    written; the solve and pose update (EPILOGUE_FLOPS) and T_inv of the
    next state (one more se3_exp, ~150)."""
    return (N_SUMS + 7 + STATE + 3) * 4, EPILOGUE_FLOPS + 150


def step_plain(sums, xi0, state, residuals, update_norms, valid_counts, it: int,
               cfg: TrackerConfig):
    """The step kernel's contract in PyTorch ops.  At ``it`` = SEED: the
    level's first state from ``xi0`` (T_inv rows, xi, not done), nothing
    else.  Else ``gn_step_plain`` on the unpacked sums at the state's xi,
    then ``dvo_tpu``'s scan: xi frozen once the state says done, the
    statistics at slot ``it`` whether or not it is; the next state in
    place."""
    if it == SEED:
        state[:12] = lie.se3_exp(-xi0)[:3].reshape(12)
        state[12:18] = xi0
        state[18] = 0.0
        return
    Hmat, g, rsum, count = unpack_sums(sums)
    xi = state[12:18].clone()
    done = state[18] != 0
    new_xi, mean_res, upd, converged = gn_step_plain(Hmat, g, rsum, count, xi, cfg)
    residuals[it] = mean_res
    update_norms[it] = upd
    valid_counts[it] = count
    xi_out = torch.where(done, xi, new_xi)
    state[:12] = lie.se3_exp(-xi_out)[:3].reshape(12)
    state[12:18] = xi_out
    state[18] = (done | converged).to(state.dtype)


def step_launcher(sums, xi0, state, residuals, update_norms, valid_counts, cfg: TrackerConfig):
    """A level's GN steps from its (all-reduced) ``sums`` (29,), checked
    once.  Returns ``step(it)``: ``step(SEED)`` writes the level's first
    state from ``xi0`` (6,) into ``state`` (STATE,); ``step(it)`` for ``it``
    in [0, max_iterations) runs step ``it`` from the state's xi, which its
    ``done`` freezes (``dvo_tpu``'s scan), writes the step's statistics at
    slot ``it`` of ``residuals``, ``update_norms`` and ``valid_counts``
    whether or not the level has converged, and the next state into
    ``state``.  On CPU tensors ``step`` runs ``step_plain``; on CUDA tensors
    each call is one launch of ``csrc/gn.cu``'s step kernel on the stream
    that was current here (it launches or raises, and never
    synchronises)."""
    outs = (residuals, update_norms, valid_counts)
    n = cfg.max_iterations

    def check(it):
        if not SEED <= it < n:
            raise ValueError(f"step {it} of {n}")

    if resolve_device(sums) == "plain":
        def step_on_cpu(it):
            check(it)
            step_plain(sums, xi0, state, *outs, it, cfg)

        return step_on_cpu
    dev = sums.device
    f32 = torch.float32
    for name, t, dtype, shape in (("sums", sums, f32, (N_SUMS,)), ("xi0", xi0, f32, (6,)),
                                  ("state", state, f32, (STATE,)),
                                  ("residuals", residuals, f32, (n,)),
                                  ("update_norms", update_norms, f32, (n,)),
                                  ("valid_counts", valid_counts, torch.int32, (n,))):
        _build.require(t, name, dtype, shape, dev)
    lib = _build.library()
    ptrs = (sums.data_ptr(), xi0.data_ptr(), state.data_ptr(), *(t.data_ptr() for t in outs))
    scalars = (cfg.damping, cfg.min_update_norm, cfg.min_residual, _build.stream_handle(dev))

    def step(it):
        check(it)
        code = lib.dvo_gn_step(*ptrs, it, *scalars)
        _build.check(code, "gn_step")
        _build.LAUNCHES["gn_step"] += 1

    return step
