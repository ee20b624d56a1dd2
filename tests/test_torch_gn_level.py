"""The GN level loop of the port (``ops.cuda.gn_level``) on the CPU.

* ``gn_level_plain`` against ``dvo_tpu.models.tracker.track_level`` with
  both of its loops (the masked scan and the early-exit while loop) on the
  rendered rig of ``test_torch_tracker``, with that file's tolerances: the
  twist within 1e-5, iteration and valid counts equal, residuals within 1e-4
  and update norms within 1e-3 relative (XLA and PyTorch sum the pixel terms
  in different orders).
* A scalar, operation-by-operation PyTorch transcription of the epilogue
  that ``csrc/gn_level.cu`` runs in one thread (6x6 Cholesky solve,
  ``se3_exp``, ``se3_log``, compose, the guards and the convergence test)
  against the port's ``gn_solve`` + ``lie.compose`` and against
  ``dvo_tpu``'s.  Tolerances: the solve within 1e-4 relative (LAPACK
  against a hand-written factorisation, as ``test_gn_solve_matches``), the
  composed twist within 2e-6 (float32 trigonometry in another order).
* The same transcription extended to ``csrc/gn.cu``'s step kernel
  (``step_kernel_scalar``: the freeze of ``dvo_tpu``'s scan, statistics
  recorded after convergence, a zero count, a non-positive-definite H)
  against ``gn_level.step_plain`` (``gn_step_plain`` on the kernel's
  buffers) and against the body of ``dvo_tpu.parallel.tracking``'s scan on
  the same sums, over a few steps: twists within 5e-6 (the composed twist's
  2e-6 a step), statistics within 1e-4 relative (the solve's tolerance),
  counts, flags and the frozen steps exact.
* The 29-sum pack of ``gn_terms_plain`` (``gn.pack_sums`` /
  ``gn.unpack_sums``), mirrored back exactly.
* ``EmulatedGNLibrary``: ``csrc/gn.cu``'s C entries behind their ctypes
  arguments (the linearisation through ``gn_terms_plain`` on the arrays
  behind its pointers, the step through ``step_kernel_scalar``), which
  drives the sharded tracker's CUDA route on the CPU (here on one rank;
  on four gloo ranks in ``test_torch_sharded.py``).
* The ``work()`` byte and operation counts of all five kernels at 120x160
  and the bound they give.
"""

import ctypes
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu import lie as jlie
from dvo_tpu.config import TrackerConfig
from dvo_tpu.models import tracker as jtracker
from dvo_tpu.parallel import tracking as jtracking
from dvo_tpu_torch import lie as tlie
from dvo_tpu_torch.config import MapperConfig, config_from_reference
from dvo_tpu_torch.config import TrackerConfig as TTrackerConfig
from dvo_tpu_torch.models import tracker as ttracker
from dvo_tpu_torch.ops.cuda import _build, epipolar, framebuild, gn, gn_level, regularize

from test_torch_tracker import _frames, _port

torch.set_num_threads(1)


# ------------------------------------------------- the plain loop vs dvo_tpu

@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("xi_true,xi0,level,cfg", [
    ([0.01, -0.004, 0.006, 0.002, -0.002, 0.003], [0, 0, 0, 0, 0, 0], 0, TrackerConfig()),
    ([0.01, -0.004, 0.006, 0.002, -0.002, 0.003], [0.009, -0.003, 0.005, 0.002, -0.002, 0.003], 1,
     TrackerConfig()),
    ([0.008, 0.002, -0.004, 0.0, 0.003, 0.0], [0, 0, 0, 0, 0, 0], 1,
     TrackerConfig(min_residual=0.0, max_iterations=6)),
    ([0.004, 0.0, 0.002, 0.0, 0.001, 0.0], [0, 0, 0, 0, 0, 0], 2,      # the crop level
     TrackerConfig(compat_weight_b_only=True, max_iterations=5)),
])
def test_gn_level_plain_matches_track_level(rng, early_exit, xi_true, xi0, level, cfg):
    obj, ref = _frames(rng, 60, 80, 2, np.asarray(xi_true, np.float32))
    scene = min(level, 1)
    cfg = dataclasses.replace(cfg, early_exit=early_exit)
    jxi, (jres, jupd, jcnt, jit) = jtracker.track_level(
        obj.scenes[scene], ref.scenes[scene], jnp.asarray(xi0, jnp.float32), level, cfg)
    to, tr = _port(obj).scenes[scene], _port(ref).scenes[scene]
    xi, res, upd, cnt, iters = gn_level.gn_level(
        ttracker.level_planes(to, tr), tr.K, torch.tensor(xi0, dtype=torch.float32), level,
        config_from_reference(cfg))
    n = cfg.max_iterations
    assert res.shape == upd.shape == cnt.shape == (n,) and iters.shape == ()
    assert cnt.dtype == iters.dtype == torch.int32
    assert int(iters) == int(jit) and 1 <= int(iters) <= n
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(xi.numpy(), np.asarray(jxi), rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(upd.numpy(), np.asarray(jupd), rtol=1e-3, atol=1e-7)
    # past the last active step every statistic is 0
    k = int(iters)
    assert not res[k:].any() and not upd[k:].any() and not cnt[k:].any()


def test_gn_level_plain_without_a_valid_pixel(rng):
    """No pixel passes the gates: one step, mean residual -1, a zero update,
    and the twist composed with zero (xi0 up to float noise)."""
    obj, ref = _frames(rng, 24, 32, 1, np.zeros(6, np.float32))
    to, tr = _port(obj).scenes[0], _port(ref).scenes[0]
    planes = list(ttracker.level_planes(to, tr))
    planes[1] = torch.zeros_like(planes[1])
    xi0 = torch.tensor([0.01, 0.0, -0.02, 0.001, 0.0, 0.002])
    cfg = config_from_reference(TrackerConfig())
    xi, res, upd, cnt, iters = gn_level.gn_level(tuple(planes), tr.K, xi0, 0, cfg)
    assert int(iters) == 1 and res[0].item() == -1.0 and not res[1:].any()
    assert not upd.any() and not cnt.any()
    torch.testing.assert_close(xi, xi0, rtol=0, atol=1e-7)


def test_track_level_is_the_level_loop(rng):
    """``tracker.track_level`` hands its level to ``gn_level``, and the
    stepwise form of the loop (another terms function) gives the same
    numbers when that function is the plain one."""
    obj, ref = _frames(rng, 24, 32, 1, np.array([0.004, 0, 0.002, 0, 0.001, 0], np.float32))
    to, tr = _port(obj).scenes[0], _port(ref).scenes[0]
    cfg = config_from_reference(TrackerConfig(max_iterations=4))
    xi0 = torch.zeros(6)
    xi, (res, upd, cnt, iters) = ttracker.track_level(to, tr, xi0, 0, cfg)
    calls = []

    def terms(*args):
        calls.append(1)
        return gn.gn_terms_plain(*args)

    want = gn_level.gn_level_plain(ttracker.level_planes(to, tr), tr.K, xi0, 0, cfg, terms=terms)
    assert len(calls) == cfg.max_iterations
    for a, b in zip((xi, res, upd, cnt, iters), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------- the kernel's epilogue, scalar by scalar

def f32(v):
    return torch.tensor(float(v), dtype=torch.float32)


SMALL = 1e-6


def _theta(w):
    return torch.sqrt((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2] + f32(1e-24))


def _hat(w):
    z = f32(0.0)
    return [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]


def _matmul(A, B):
    return [[(A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j] for j in range(3)]
            for i in range(3)]


def _eye_plus(a, W, b, W2):
    return [[(f32(1.0 if i == j else 0.0) + a * W[i][j]) + b * W2[i][j] for j in range(3)]
            for i in range(3)]


def _matvec(A, x):
    return [(A[i][0] * x[0] + A[i][1] * x[1]) + A[i][2] * x[2] for i in range(3)]


def se3_exp_scalar(xi):
    """gn_level.cu se3_exp: (R, t)."""
    v, w = xi[:3], xi[3:]
    th = _theta(w)
    W = _hat(w)
    W2 = _matmul(W, W)
    if th < SMALL:
        a = f32(1.0) - th * th / 6.0
        b = f32(0.5) - th * th / 24.0
        c = f32(1.0) / 6.0 - th * th / 120.0
    else:
        a = torch.sin(th) / th
        b = (f32(1.0) - torch.cos(th)) / (th * th)
        c = (th - torch.sin(th)) / (th * th * th)
    return _eye_plus(a, W, b, W2), _matvec(_eye_plus(b, W, c, W2), v)


def se3_log_scalar(R, t):
    """gn_level.cu se3_log."""
    trace = (R[0][0] + R[1][1]) + R[2][2]
    cos_th = torch.clamp((trace - 1.0) * 0.5, min=f32(-0.9999999), max=f32(1.0))
    th0 = torch.arccos(cos_th)
    vee = [R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]]
    if th0 < SMALL:
        w = [f32(0.0)] * 3
    else:
        scale = th0 / (2.0 * torch.sin(th0))
        w = [scale * v for v in vee]
    th = _theta(w)
    W = _hat(w)
    W2 = _matmul(W, W)
    half = th * 0.5
    if th < SMALL:
        cot = f32(1.0) / 12.0 + th * th / 720.0
    else:
        cot = (f32(1.0) - half * torch.cos(half) / torch.sin(half)) / (th * th)
    return _matvec(_eye_plus(f32(-0.5), W, cot, W2), t) + w


def solve6_scalar(H, g, damping):
    """gn_level.cu solve6 on the lower triangle of H; NaN on a pivot <= 0."""
    L = [[None] * 6 for _ in range(6)]
    ok = True
    for j in range(6):
        s = H[j][j] + f32(damping)
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = ok and bool(s > 0)
        d = torch.sqrt(s)
        L[j][j] = d
        for i in range(j + 1, 6):
            v = H[i][j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v / d
    y = []
    for i in range(6):
        v = g[i]
        for k in range(i):
            v = v - L[i][k] * y[k]
        y.append(v / L[i][i])
    x = [None] * 6
    for i in range(5, -1, -1):
        v = y[i]
        for k in range(i + 1, 6):
            v = v - L[k][i] * x[k]
        x[i] = v / L[i][i]
    return x if ok else [f32(float("nan"))] * 6


def gn_step_scalar(H, g, rsum, count, xi, cfg):
    """gn_level.cu gn_step.  Returns (new xi, mean residual, update norm,
    converged, delta) as Python floats / lists."""
    H = [[f32(H[i][j]) for j in range(6)] for i in range(6)]
    g, xi = [f32(v) for v in g], [f32(v) for v in xi]
    delta = solve6_scalar(H, g, cfg.damping)
    if count <= 0:
        delta = [f32(0.0)] * 6
    R0, t0 = se3_exp_scalar(xi)
    R1, t1 = se3_exp_scalar(delta)
    R = _matmul(R0, R1)
    t = [a + b for a, b in zip(_matvec(R0, t1), t0)]
    new_xi = se3_log_scalar(R, t)
    if all(bool(torch.isfinite(v)) for v in new_xi):
        xi = new_xi
    mean_res = f32(rsum) / f32(count) if count > 0 else f32(-1.0)
    sq = f32(0.0)
    for d in delta:
        sq = sq + d * d
    upd = torch.sqrt(sq)
    converged = bool(upd < cfg.min_update_norm) or bool(mean_res < cfg.min_residual) \
        or count == 0
    return ([v.item() for v in xi], mean_res.item(), upd.item(), converged,
            [d.item() for d in delta])


def _normal_equations(rng, scale):
    A = rng.standard_normal((6, 6)).astype(np.float32)
    H = (A @ A.T + np.eye(6, dtype=np.float32)).astype(np.float32) * np.float32(scale)
    return H, rng.standard_normal(6).astype(np.float32)


EPILOGUE_CASES = {
    # name: (H scale, g scale, xi, count)
    "typical": (50.0, 0.5, [0.01, -0.02, 0.03, 0.002, -0.001, 0.003], 900),
    "small_angle": (1e9, 1.0, [0.0, 0.0, 0.0, 2e-7, -1e-7, 0.0], 900),      # |w| < 1e-6 twice
    "large_angle": (1.0, 1.0, [0.3, -0.2, 0.1, 1.4, -1.1, 0.9], 900),       # |w| ~ 2 rad
    "translation_only": (50.0, 0.5, [0.1, 0.2, -0.3, 0.0, 0.0, 0.0], 12),
}


@pytest.mark.parametrize("case", list(EPILOGUE_CASES))
def test_epilogue_transcription_matches_solve_and_compose(rng, case):
    h_scale, g_scale, xi, count = EPILOGUE_CASES[case]
    H, g = _normal_equations(rng, h_scale)
    g = g * np.float32(g_scale)
    cfg = config_from_reference(TrackerConfig())
    new_xi, mean_res, upd, converged, delta = gn_step_scalar(H, g, 9.0, count, xi, cfg)

    t_delta = ttracker.gn_solve(torch.tensor(H), torch.tensor(g), torch.tensor(count),
                                cfg.damping)
    j_delta = jtracker.gn_solve(jnp.asarray(H), jnp.asarray(g), jnp.asarray(count), cfg.damping)
    np.testing.assert_allclose(delta, t_delta.numpy(), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(delta, np.asarray(j_delta), rtol=1e-4, atol=1e-9)
    if case == "small_angle":
        assert np.linalg.norm(delta[3:]) < 1e-6 and np.linalg.norm(xi[3:]) < 1e-6

    t_xi = tlie.compose(torch.tensor(xi, dtype=torch.float32), t_delta)
    j_xi = jlie.compose(jnp.asarray(xi, jnp.float32), j_delta)
    np.testing.assert_allclose(new_xi, t_xi.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(new_xi, np.asarray(j_xi), rtol=0, atol=2e-6)
    assert mean_res == np.float32(9.0) / np.float32(count)
    np.testing.assert_allclose(upd, torch.linalg.vector_norm(t_delta).item(), rtol=1e-4)
    # the thresholds compare in float32, as on the card
    assert converged == bool(np.float32(upd) < np.float32(cfg.min_update_norm)
                             or np.float32(mean_res) < np.float32(cfg.min_residual))


def test_epilogue_non_positive_definite_keeps_xi(rng):
    """A pivot that is not > 0: NaN update, as ``gn_solve`` and JAX's
    Cholesky give; the twist is kept and the step does not count as
    converged (NaN compares false)."""
    H = -np.eye(6, dtype=np.float32)
    xi = [0.01, 0.0, -0.02, 0.001, 0.0, 0.002]
    cfg = config_from_reference(TrackerConfig(min_residual=0.0))
    new_xi, mean_res, upd, converged, delta = gn_step_scalar(H, np.ones(6), 2.0, 5, xi, cfg)
    assert all(np.isnan(delta)) and np.isnan(upd) and not converged
    assert new_xi == [np.float32(v).item() for v in xi] and mean_res == np.float32(0.4)
    assert torch.isnan(ttracker.gn_solve(torch.tensor(H), torch.ones(6), torch.tensor(5),
                                         cfg.damping)).all()
    # H = 0 with damping is positive definite: a huge but finite update
    assert all(np.isfinite(gn_step_scalar(np.zeros((6, 6)), np.ones(6) * 1e-9, 2.0, 5, xi,
                                          cfg)[4]))


def test_epilogue_count_zero_gives_zero_update(rng):
    H, g = _normal_equations(rng, 10.0)
    xi = [0.01, 0.0, -0.02, 0.001, 0.0, 0.002]
    cfg = config_from_reference(TrackerConfig())
    new_xi, mean_res, upd, converged, delta = gn_step_scalar(H, g, 0.0, 0, xi, cfg)
    assert delta == [0.0] * 6 and upd == 0.0 and mean_res == -1.0 and converged
    want = tlie.compose(torch.tensor(xi), torch.zeros(6))
    np.testing.assert_allclose(new_xi, want.numpy(), rtol=0, atol=2e-7)
    np.testing.assert_allclose(new_xi, xi, rtol=0, atol=2e-7)
    assert not ttracker.gn_solve(torch.tensor(H), torch.tensor(g), torch.tensor(0),
                                 cfg.damping).any()


# ------------------- gn.cu's step kernel: the sharded scan's step, transcribed

def _mirror(acc):
    """H (6x6 nested list) from the lower triangle of the 29 sums."""
    return [[acc[max(i, j) * (max(i, j) + 1) // 2 + min(i, j)] for j in range(6)]
            for i in range(6)]


def write_state_scalar(xi):
    """gn_step.cuh write_state without the flag: T_inv = se3_exp(-xi) rows
    0-2 (12 floats), then xi."""
    R, t = se3_exp_scalar([f32(-v) for v in xi])
    rows = [v.item() for i in range(3) for v in (*R[i], t[i])]
    return rows + [f32(v).item() for v in xi]


def step_kernel_scalar(sums, xi0, state, it, cfg):
    """gn.cu gn_step_kernel: at it = -1 the level's first state from xi0
    (no statistics: None); else gn_step (above) from the 29 sums at the
    state's xi, then dvo_tpu's scan: a done state freezes xi, the
    statistics are recorded either way.  Returns (the next state, 19
    floats; (mean residual, update norm, count))."""
    if it == gn_level.SEED:
        return write_state_scalar(xi0) + [0.0], None
    acc = [f32(v).item() for v in sums]
    done = state[18] != 0.0
    xi = [f32(v).item() for v in state[12:18]]
    new_xi, mean_res, upd, converged, _ = gn_step_scalar(_mirror(acc), acc[21:27], acc[27],
                                                         int(acc[28]), xi, cfg)
    out = xi if done else new_xi
    return write_state_scalar(out) + [1.0 if done or converged else 0.0], (mean_res, upd,
                                                                          int(acc[28]))


STEPS = 3
STEP_XI0 = [0.01, -0.02, 0.03, 0.002, -0.001, 0.003]
STEP_CASES = {
    # name: (H scale (None: -I), count, config); the same sums every step
    "moving": (50.0, 900, dict(min_update_norm=0.0, min_residual=0.0)),     # never converges
    "freeze": (50.0, 900, dict(min_update_norm=1e9)),    # converges at step 0, then frozen
    "zero_count": (10.0, 0, {}),                         # zero update, converged at once
    "not_pd": (None, 5, dict(min_residual=0.0)),          # NaN update, xi kept, never converges
}


def _step_sums(rng, case):
    h_scale, count, kw = STEP_CASES[case]
    H, g = _normal_equations(rng, 1.0 if h_scale is None else h_scale)
    if h_scale is None:
        H = -np.eye(6, dtype=np.float32)
    g = (g * np.float32(0.5)).astype(np.float32)
    rsum = np.float32(2.0 if count else 0.0)
    sums = gn.pack_sums(torch.tensor(H), torch.tensor(g), torch.tensor(rsum),
                        torch.tensor(count, dtype=torch.int32))
    return H, g, rsum, count, sums, TrackerConfig(max_iterations=STEPS, **kw)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_kernel_transcription_matches_the_plain_step_and_dvo_tpu_scan(rng, case,
                                                                           monkeypatch):
    """``STEPS`` steps on the same sums: the transcription against
    ``step_plain`` (the port's PyTorch ops on the kernel's buffers) and
    against ``dvo_tpu``'s sharded scan body (its linearisation replaced by
    these sums)."""
    H, g, rsum, count, sums, jcfg = _step_sums(rng, case)
    cfg = config_from_reference(jcfg)
    state, _ = step_kernel_scalar(sums.tolist(), STEP_XI0, [float("nan")] * 19, gn_level.SEED,
                                  cfg)
    stats, states = [], []
    for it in range(STEPS):
        state, st = step_kernel_scalar(sums.tolist(), STEP_XI0, state, it, cfg)
        states.append(state)
        stats.append(st)
    res, upd, cnt = (np.asarray(v) for v in zip(*stats))

    xi0 = torch.tensor(STEP_XI0)
    t_state = torch.full((19,), float("nan"))
    t_res, t_upd = torch.zeros(STEPS), torch.zeros(STEPS)
    t_cnt = torch.zeros(STEPS, dtype=torch.int32)
    for it in range(gn_level.SEED, STEPS):
        gn_level.step_plain(sums, xi0, t_state, t_res, t_upd, t_cnt, it, cfg)

    monkeypatch.setattr(jtracking, "sharded_gn_normal_equations", lambda *a, **k: (
        jnp.asarray(H), jnp.asarray(g), jnp.asarray(rsum), jnp.asarray(count, jnp.int32)))
    jxi, (jres, jupd, jcnt) = jtracking.sharded_track_level(
        None, None, jnp.asarray(STEP_XI0, jnp.float32), 0, jcfg, None)

    xi = np.asarray(state[12:18], np.float32)
    for other_xi, other in ((t_state[12:18].numpy(), (t_res, t_upd, t_cnt)),
                            (np.asarray(jxi), (jres, jupd, jcnt))):
        np.testing.assert_allclose(xi, other_xi, rtol=0, atol=5e-6)
        np.testing.assert_array_equal(res.astype(np.float32), np.asarray(other[0]))
        np.testing.assert_allclose(upd, np.asarray(other[1]), rtol=1e-4, atol=1e-9)
        np.testing.assert_array_equal(cnt, np.asarray(other[2]))
    assert state[18] == t_state[18].item()
    np.testing.assert_allclose(np.asarray(state[:12], np.float32), t_state[:12].numpy(), rtol=0,
                               atol=5e-6)
    # every step's statistics are recorded; a frozen step keeps xi bit for bit
    converged_at = {"moving": None, "freeze": 0, "zero_count": 0, "not_pd": None}[case]
    for it in range(1, STEPS):
        assert stats[it][0] == stats[0][0] and stats[it][2] == count
        if converged_at is not None and it > converged_at:
            assert states[it][12:18] == states[it - 1][12:18]
            assert states[it][:12] == states[it - 1][:12]
    assert (state[18] == 1.0) == (converged_at is not None)
    if case == "moving":
        assert np.abs(xi - np.float32(STEP_XI0)).max() > 1e-3
    if case == "not_pd":
        assert np.isnan(upd).all() and xi.tolist() == np.float32(STEP_XI0).tolist()
    if case == "zero_count":
        assert (res == -1.0).all() and (upd == 0.0).all()


@pytest.mark.parametrize("weight_b_only", [False, True])
@pytest.mark.parametrize("level", [0, 2])      # 2: the crop level
def test_pack_sums_mirrors_back_exactly(rng, weight_b_only, level):
    """``gn_terms_plain``'s (H, g, residual sum, count) packed into the 29
    sums and unpacked: H on and below the diagonal, g, the residual sum and
    the count exactly; above the diagonal H's lower triangle, which the
    plain H has there up to float noise (each product and the einsum's sum
    in another order: within 1e-5 of H's largest entry)."""
    obj, ref = _frames(rng, 60, 80, 1, np.array([0.004, 0, 0.002, 0, 0.001, 0], np.float32))
    to, tr = _port(obj).scenes[0], _port(ref).scenes[0]
    cfg = config_from_reference(TrackerConfig(compat_weight_b_only=weight_b_only))
    terms = gn.gn_terms_plain(*ttracker.level_planes(to, tr), tr.K, torch.eye(4), level, cfg)
    sums = gn.pack_sums(*terms)
    assert sums.shape == (gn.N_SUMS,) and sums.dtype == torch.float32
    H, g, rsum, count = gn.unpack_sums(sums)
    lower = torch.tril(torch.ones(6, 6, dtype=torch.bool))
    assert torch.equal(H[lower], terms[0][lower]) and torch.equal(H, H.T)
    assert torch.equal(g, terms[1]) and torch.equal(rsum, terms[2])
    assert count.dtype == torch.int32 and int(count) == int(terms[3]) > 500
    torch.testing.assert_close(terms[0], terms[0].T, rtol=0,
                               atol=1e-5 * terms[0].abs().max().item())


def _arr(ptr, shape, ctype=ctypes.c_float):
    n = int(np.prod(shape))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


class EmulatedGNLibrary:
    """``csrc/gn.cu``'s C entries behind their ctypes arguments, in order:
    ``dvo_gn_terms`` runs ``gn_terms_plain`` on the arrays behind its
    pointers at the pose the kernel reads (T_inv's rows 0-2) and packs the
    29 sums, after writing every partials slot, leaving the ticket at 0;
    ``dvo_gn_step`` runs ``step_kernel_scalar``; ``dvo_gn_level``
    (``csrc/gn_level.cu``, for the levels a sharded track leaves whole) runs
    ``gn_level_plain``."""

    def dvo_gn_num_blocks(self, n):
        return gn.num_blocks(n)

    def dvo_gn_terms(self, obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray, ref_mask, ref_gx,
                     ref_gy, ref_gmask, K, T_inv, sums, partials, ticket, h, w,
                     y_offset, full_h, full_w, step, min_depth, sigma_lo, sigma_hi,
                     weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1, stream):
        u8 = ctypes.c_uint8
        assert _arr(ticket, (1,), ctypes.c_uint32)[0] == 0 and 0 <= y_offset <= full_h - h
        # the launch's scratch, overwritten as the kernel does: a buffer that
        # shares its memory with the partials is caught here
        _arr(partials, (gn.num_blocks(h * w), gn.N_SUMS))[:] = np.nan
        t = lambda ptr, shape, ct=ctypes.c_float: torch.from_numpy(_arr(ptr, shape, ct))
        block = (t(obj_gray, (h, w)), t(obj_mask, (h, w), u8).bool(), t(ref_depth, (h, w)),
                 t(ref_sigma, (h, w)))
        f = (full_h, full_w)
        whole = (t(ref_gray, f), t(ref_mask, f, u8).bool(), t(ref_gx, f), t(ref_gy, f),
                 t(ref_gmask, f, u8).bool())
        rows = _arr(T_inv, (12,)).tolist()
        T = torch.tensor(rows + [0.0, 0.0, 0.0, 1.0], dtype=torch.float32).reshape(4, 4)
        cfg = TTrackerConfig(level_steps=(step,), min_depth=min_depth,
                             sigma_clamp=(sigma_lo, sigma_hi),
                             compat_weight_b_only=bool(weight_b_only),
                             crop_level=0 if crop else -1, crop_x=(crop_x0, crop_x1),
                             crop_y=(crop_y0, crop_y1))
        terms = gn.gn_terms_plain(*block, *whole, t(K, (3, 3)), T, 0, cfg, y_offset, f)
        _arr(sums, (gn.N_SUMS,))[:] = gn.pack_sums(*terms).numpy()
        return 0

    def dvo_gn_level(self, *args):
        """The level kernel's contract through ``gn_level_plain`` (a sharded
        track runs a level the tile count does not divide on it)."""
        (*planes, K, xi0, xi, residuals, update_norms, valid_counts, iterations, _stamps, h, w,
         step, min_depth, sigma_lo, sigma_hi, weight_b_only, crop, crop_x0, crop_x1, crop_y0,
         crop_y1, n, damping, min_update_norm, min_residual, _stream) = args
        t = lambda ptr, shape, ct=ctypes.c_float: torch.from_numpy(_arr(ptr, shape, ct))
        kinds = (None, "mask", None, None, None, "mask", None, None, "mask")
        planes = tuple(t(p, (h, w), ctypes.c_uint8).bool() if k else t(p, (h, w))
                       for p, k in zip(planes, kinds))
        cfg = TTrackerConfig(level_steps=(step,), min_depth=min_depth,
                             sigma_clamp=(sigma_lo, sigma_hi),
                             compat_weight_b_only=bool(weight_b_only),
                             crop_level=0 if crop else -1, crop_x=(crop_x0, crop_x1),
                             crop_y=(crop_y0, crop_y1), max_iterations=n, damping=damping,
                             min_update_norm=min_update_norm, min_residual=min_residual)
        out = gn_level.gn_level_plain(planes, t(K, (3, 3)), t(xi0, (6,)).clone(), 0, cfg)
        for ptr, v, ct in zip((xi, residuals, update_norms, valid_counts, iterations), out,
                              (ctypes.c_float,) * 3 + (ctypes.c_int32,) * 2):
            _arr(ptr, tuple(v.shape) or (1,), ct)[:] = v.reshape(-1).numpy()
        return 0

    def dvo_gn_step(self, sums, xi0, state, residuals, update_norms, valid_counts, it, damping,
                    min_update_norm, min_residual, stream):
        cfg = SimpleNamespace(damping=damping, min_update_norm=min_update_norm,
                              min_residual=min_residual)
        st = _arr(state, (19,))
        new, stats = step_kernel_scalar(_arr(sums, (gn.N_SUMS,)).tolist(),
                                        _arr(xi0, (6,)).tolist(), st.tolist(), it, cfg)
        st[:] = new
        if stats is None:       # the seed
            return 0
        mean_res, upd, count = stats
        _arr(residuals, (it + 1,))[it] = mean_res
        _arr(update_norms, (it + 1,))[it] = upd
        _arr(valid_counts, (it + 1,), ctypes.c_int32)[it] = count
        return 0


def emulate_cuda_route(monkeypatch):
    """The sharded tracker takes its CUDA route on CPU tensors, through
    ``EmulatedGNLibrary``."""
    for mod in (gn, gn_level):
        monkeypatch.setattr(mod, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", EmulatedGNLibrary)
    monkeypatch.setattr(_build, "stream_handle", lambda _: 0)


def test_sharded_level_cuda_route_on_one_rank_matches_the_plain_route(rng, monkeypatch):
    """``sharded_track_level``'s CUDA route (a one-rank gloo group, the
    emulated library): ``max_iterations`` launches of ``gn``, one more of
    ``gn_step`` (the seed), every statistics slot filled, and the plain
    route's xi and statistics within 1e-6, the counts equal.
    Then ``sharded_track`` over two levels likewise."""
    import torch.distributed as dist

    from dvo_tpu_torch.parallel import make_mesh, sharded_track, sharded_track_level

    obj, ref = _frames(rng, 48, 64, 2, np.array([0.01, -0.004, 0.006, 0.002, -0.002, 0.003],
                                                np.float32))
    to, tr = _port(obj), _port(ref)
    cfg = config_from_reference(TrackerConfig(max_iterations=6, min_residual=0.0))
    xi0 = torch.zeros(6)
    assert not dist.is_initialized()
    mesh = make_mesh((1,), ("tile",), device="cpu")
    try:
        want = sharded_track_level(to.scenes[1], tr.scenes[1], xi0, 1, cfg, mesh)
        want_track = sharded_track(to, tr, cfg, mesh)
        with monkeypatch.context() as m:
            emulate_cuda_route(m)
            _build.reset_launches()
            got = sharded_track_level(to.scenes[1], tr.scenes[1], xi0, 1, cfg, mesh)
            launches = dict(_build.LAUNCHES)
            got_track = sharded_track(to, tr, cfg, mesh)
            track_launches = dict(_build.LAUNCHES)
            _build.reset_launches()
    finally:
        dist.destroy_process_group()
    n = cfg.max_iterations
    assert launches["gn"] == launches["gn_step"] - 1 == n and launches["gn_level"] == 0
    assert track_launches["gn"] == track_launches["gn_step"] - 3 == 3 * n
    xi, (res, upd, cnt) = got
    assert res.shape == upd.shape == cnt.shape == (n,) and cnt.dtype == torch.int32
    assert bool(torch.isfinite(res).all() and (res > 0).all() and (cnt > 500).all())
    torch.testing.assert_close(xi, want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(res, want[1][0], rtol=0, atol=1e-6)
    torch.testing.assert_close(upd, want[1][1], rtol=0, atol=1e-6)
    assert torch.equal(cnt, want[1][2])
    assert float(upd[-1]) < float(upd[0])          # the level moved and settled
    torch.testing.assert_close(got_track, want_track, rtol=0, atol=1e-6)


# ------------------------------------------------------ work() and the bound

@pytest.mark.parametrize("name,got,want", [
    # 27 B a pixel, T_inv's rows and K, the 29 sums
    ("gn", lambda: gn.work((120, 160)), (518400 + 64 + 116, 3436800)),
    ("gn_valid", lambda: gn.work((120, 160), 8431), (518580, 1574400 + 97 * 8431)),
    ("gn_block", lambda: gn.work((30, 160), 2000), (129600 + 180, 82 * 4800 + 97 * 2000)),
    # the 29 sums, the state's xi and done read; the state and 3 statistics written
    ("gn_step", gn_level.step_work, ((29 + 7 + 19 + 3) * 4, 850)),
    ("gn_level", lambda: gn_level.work((120, 160), [8431], 15), (518668, 2392907)),
    ("gn_level_3_steps", lambda: gn_level.work((120, 160), [8431, 8400, 8000], 15),
     (518668, 3 * (1574400 + 700) + 97 * (8431 + 8400 + 8000))),
    ("gn_level_no_step", lambda: gn_level.work((30, 40), [], 15), (27 * 1200 + 268, 0)),
    ("regularize", lambda: regularize.work((120, 160)), (230400, 1401600)),
    ("epipolar", lambda: epipolar.work((120, 160), 8, 206875), (4070412, 6737625)),
    ("epipolar_one_slot", lambda: epipolar.work((120, 160), 1, 0), (2323212, 1152000)),
    ("framebuild_tracking", lambda: framebuild.work((120, 160), 3, 1, True), (448800, 50400)),
    ("framebuild_pair", lambda: framebuild.work((120, 160), 3, 2, False), (355200, 0)),
    ("framebuild_rgbd", lambda: framebuild.work((212, 256), 4, 3, True),
     (12 * (54272 + 72096) + 54272 + 10 * 72096, 2 * 72096)),
])
def test_work_counts_at_the_main_path_shapes(name, got, want):
    assert got() == want


def test_bound_takes_the_larger_of_bytes_and_operations():
    us, by = _build.bound_us(*gn.work((120, 160)))
    assert by == "bytes" and us == pytest.approx(1e6 * 518580 / 3.35e12)
    us, by = _build.bound_us(*gn_level.work((120, 160), [19200] * 5, 15))
    assert by == "operations" and us == pytest.approx(1e6 * 5 * (179 * 19200 + 700) / 67e12)
    assert _build.bound_us(0, 0) == (0.0, "bytes")


def test_marched_samples_counts_what_the_inputs_need():
    fields = torch.zeros((epipolar.N_FIELDS, 2, 3))
    fields[epipolar.F_BASE_OK] = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]])
    fields[epipolar.F_LENGTH] = torch.tensor([[2.5, 500.0, 9.0], [0.0, 7.0, 10.0]])
    cfg = MapperConfig(max_steps=40)
    # ceil(length) + 4, capped at max_steps + 4, over the pixels with a base observation
    assert int(epipolar.marched_samples(fields, cfg)) == 7 + 44 + 4 + 14


# ----------------- gn_step.cuh on a warp: the lanes' schedule, bit for bit

LANES = 32


def solve6_lanes(H, g, damping):
    """gn_step.cuh solve6 on a warp, lane by lane: lane r (lanes past 5 as
    lane 5) keeps row r of L; for column j every lane forms the pivot,
    divides its own row's entry, and the column is broadcast into every
    lane's Lf; the forward substitution broadcasts y[k] from lane k; the
    back substitution runs in every lane.  Returns each lane's delta."""
    rows = [min(lane, 5) for lane in range(LANES)]
    acc = [H[a][b] for a in range(6) for b in range(a + 1)] + list(g)
    Lf = [[[None] * 6 for _ in range(6)] for _ in range(LANES)]
    row = [[None] * 6 for _ in range(LANES)]
    ok = [True] * LANES
    for j in range(6):
        for lane, r in enumerate(rows):
            base = r * (r + 1) // 2
            s = acc[j * (j + 1) // 2 + j] + f32(damping)
            for k in range(j):
                s = s - Lf[lane][j][k] * Lf[lane][j][k]
            ok[lane] = ok[lane] and bool(s > 0)
            d = torch.sqrt(s)
            v = acc[base + j]
            for k in range(j):
                v = v - row[lane][k] * Lf[lane][j][k]
            row[lane][j] = d if r == j else v / d
        for lane in range(LANES):             # __shfl_sync(row[j], i) for i >= j
            for i in range(j, 6):
                Lf[lane][i][j] = row[i][j]
    v = [acc[21 + r] for r in rows]
    y = [[None] * 6 for _ in range(LANES)]
    for k in range(6):
        q = [v[lane] / Lf[lane][k][k] for lane in range(LANES)]
        for lane in range(LANES):
            y[lane][k] = q[k]                 # __shfl_sync(q, k)
            v[lane] = v[lane] - row[lane][k] * y[lane][k]
    out = []
    for lane in range(LANES):
        delta = [None] * 6
        for i in range(5, -1, -1):
            x = y[lane][i]
            for k in range(i + 1, 6):
                x = x - Lf[lane][k][i] * delta[k]
            delta[i] = x / Lf[lane][i][i]
        out.append(delta if ok[lane] else [f32(float("nan"))] * 6)
    return out


def gn_step_lanes(H, g, rsum, count, xi, cfg):
    """gn_step.cuh gn_step on a warp: every lane's solve, then the compose's
    two exponentials in one pass (lane 1 takes exp(delta), every other lane
    exp(xi)), read back from lanes 0 and 1.  Returns each lane's result as
    ``gn_step_scalar`` gives it."""
    H = [[f32(H[i][j]) for j in range(6)] for i in range(6)]
    g, xi = [f32(v) for v in g], [f32(v) for v in xi]
    deltas = solve6_lanes(H, g, cfg.damping)
    if count <= 0:
        deltas = [[f32(0.0)] * 6 for _ in range(LANES)]
    exps = [se3_exp_scalar(deltas[lane] if lane == 1 else xi) for lane in range(LANES)]
    (R0, t0), (R1, t1) = exps[0], exps[1]
    out = []
    for lane in range(LANES):
        delta = deltas[lane]
        R = _matmul(R0, R1)
        t = [a + b for a, b in zip(_matvec(R0, t1), t0)]
        new_xi = se3_log_scalar(R, t)
        x = new_xi if all(bool(torch.isfinite(v)) for v in new_xi) else xi
        mean_res = f32(rsum) / f32(count) if count > 0 else f32(-1.0)
        sq = f32(0.0)
        for d in delta:
            sq = sq + d * d
        upd = torch.sqrt(sq)
        converged = bool(upd < cfg.min_update_norm) or bool(mean_res < cfg.min_residual) \
            or count == 0
        out.append(([v.item() for v in x], mean_res.item(), upd.item(), converged,
                    [d.item() for d in delta]))
    return out


WARP_CASES = dict(EPILOGUE_CASES, not_pd=(None, 1.0, [0.01, 0.0, -0.02, 0.001, 0.0, 0.002], 5),
                  zero_count=(10.0, 1.0, [0.01, 0.0, -0.02, 0.001, 0.0, 0.002], 0))


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_step_is_the_one_thread_step_bit_for_bit(rng, case):
    """The warp's schedule (``solve6_lanes``, ``gn_step_lanes``) gives
    every lane the one-thread transcription's delta, twist, statistics and
    flag, bit for bit (float32; NaN where it gives NaN): no element's
    arithmetic changes order."""
    h_scale, g_scale, xi, count = WARP_CASES[case]
    H, g = _normal_equations(rng, 1.0 if h_scale is None else h_scale)
    if h_scale is None:
        H = -np.eye(6, dtype=np.float32)
    g = (g * np.float32(g_scale)).astype(np.float32)
    cfg = config_from_reference(TrackerConfig(min_residual=0.0))
    want = gn_step_scalar(H, g, 9.0, count, xi, cfg)
    Hf = [[f32(H[i][j]) for j in range(6)] for i in range(6)]
    want_delta = np.asarray([v.item() for v in solve6_scalar(Hf, [f32(v) for v in g],
                                                             cfg.damping)], np.float32)
    for delta in solve6_lanes(Hf, [f32(v) for v in g], cfg.damping):
        np.testing.assert_array_equal(np.asarray([v.item() for v in delta], np.float32),
                                      want_delta)
    for got in gn_step_lanes(H, g, 9.0, count, xi, cfg):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    if case == "not_pd":
        assert np.isnan(want_delta).all()


# --------------------------- the level kernel's launch shape and sum order

def _level_shapes(base, levels):
    h, w = base
    return [((h + (1 << k) - 1) >> k, (w + (1 << k) - 1) >> k) for k in range(levels)]


@pytest.mark.parametrize("rig,base,levels,want", [
    # DVOConfig.monocular(): 640x480 culled twice, 3 levels
    ("monocular", (120, 160), 3, [(16, 512), (16, 512), (8, 256)]),
    # DVOConfig.rgbd(): 512x424 culled once, 4 levels
    ("rgbd", (212, 256), 4, [(16, 1024), (16, 512), (8, 512), (8, 256)]),
    # Kinect mono (chip_smoke.py): the 512x424 depth view culled twice, 3 levels
    ("kinect_mono", (106, 128), 3, [(16, 512), (8, 512), (8, 256)]),
])
def test_launch_shape_at_every_level_of_the_rigs(rig, base, levels, want):
    """``gn_level.launch_shape`` (the mirror of ``csrc/gn_level.cu``'s
    ``level_shape``, held against its C entries on the card) at every
    level, finest first: a cluster of 8 blocks of 256 threads up to 1,200
    pixels, of 8 of 512 up to 4,096, of 16 of 512 up to 32,768, of 16 of
    1024 above (the least cycles a step of ``tools/gn_level_stamps``'
    sweep at each of these levels)."""
    from dvo_tpu_torch.config import DVOConfig

    cfg = {"monocular": DVOConfig.monocular(), "rgbd": DVOConfig.rgbd(),
           "kinect_mono": DVOConfig.monocular()}[rig]
    assert cfg.pyramid.levels == levels
    shapes = _level_shapes(base, levels)
    got = [gn_level.launch_shape(h, w) for h, w in shapes]
    assert got == want
    for (h, w), shape in zip(shapes, got):
        n = h * w
        assert shape == ((8, 256) if n <= 1200 else (8, 512) if n <= 4096 else
                         (16, 512) if n <= 32768 else (16, 1024))


def kernel_sums(J, r, weight, valid, weight_b_only, blocks, threads):
    """The level kernel's 29 sums over per-pixel terms, in its order
    (float32, NumPy): thread ``rank * threads + tid`` adds the terms of its
    pixels (a stride of blocks * threads) in index order; each warp
    reduce-scatters its lanes' 32 sums (``fold`` with O = 16, 8, 4, 2, 1:
    a lane keeps the half its bit O selects and adds its partner's copy);
    a block adds its warps' sums in order from 0, the cluster its blocks in
    rank order from 0."""
    f = np.float32
    n = J.shape[0]
    terms = np.zeros((n, 32), f)
    ja = J if weight_b_only else J * weight[:, None]
    for a in range(6):
        for b in range(a + 1):
            terms[:, a * (a + 1) // 2 + b] = ja[:, a] * J[:, b]
        terms[:, 21 + a] = J[:, a] * (r * weight)
    terms[:, 27] = r * r
    terms[:, 28] = 1.0
    terms[~valid] = 0.0
    stride = blocks * threads
    passes = -(-n // stride)
    padded = np.zeros((passes * stride, 32), f)
    padded[:n] = terms
    t = np.zeros((stride, 32), f)
    for k in range(passes):                       # a thread's pixels in index order
        t = t + padded[k * stride:(k + 1) * stride]
    t = t.reshape(blocks, threads // 32, 32, 32)  # (block, warp, lane, value)
    lanes = np.arange(32)
    for O in (16, 8, 4, 2, 1):
        upper = ((lanes & O) != 0)[:, None]
        send = np.where(upper, t[..., :O], t[..., O:2 * O])
        keep = np.where(upper, t[..., O:2 * O], t[..., :O])
        t = keep + send[:, :, lanes ^ O, :]
    warp_sums = t[..., 0]                         # lane l: the warp's sum of value l
    block = np.zeros((blocks, 32), f)
    for w in range(threads // 32):
        block = block + warp_sums[:, w]
    total = np.zeros(32, f)
    for b in range(blocks):
        total = total + block[b]
    return total[:gn.N_SUMS]


@pytest.mark.parametrize("hw", [(27, 32), (53, 64), (60, 80), (106, 128), (212, 256)])
@pytest.mark.parametrize("weight_b_only", [False, True])
def test_kernel_sum_order_matches_the_plain_sums(rng, hw, weight_b_only):
    """``kernel_sums`` at the level's launch shape, over
    ``gn.pixel_terms_plain``'s per-pixel terms, against ``gn_terms_plain``'s
    sums at ``chip_smoke.GN_REL_TOL`` of each part's largest entry (the two
    add the same products in different orders), the count exact; and the
    count against ``dvo_tpu``'s."""
    from chip_smoke import GN_REL_TOL

    h, w = hw
    obj, ref = _frames(rng, h, w, 1, np.array([0.006, -0.002, 0.004, 0.001, -0.001, 0.002],
                                              np.float32))
    to, tr = _port(obj).scenes[0], _port(ref).scenes[0]
    cfg = config_from_reference(TrackerConfig(compat_weight_b_only=weight_b_only))
    T = tlie.se3_exp(-torch.tensor([0.001, 0.001, 0.0, 0.0005, 0.0, 0.0]))
    args = (*ttracker.level_planes(to, tr), tr.K, T, 1, cfg)
    J, r, weight, valid = (x.reshape(h * w, -1).squeeze(-1).numpy()
                           for x in gn.pixel_terms_plain(*args))
    got = kernel_sums(J, r, weight, valid, weight_b_only, *gn_level.launch_shape(h, w))
    want = gn.pack_sums(*gn.gn_terms_plain(*args)).numpy()
    assert got[28] == want[28] == valid.sum() > 0.5 * h * w
    for part in (slice(0, 21), slice(21, 27), slice(27, 28)):
        scale = np.abs(want[part]).max()
        assert np.abs(got[part] - want[part]).max() <= GN_REL_TOL * scale


# ------------------------------------------ the count's float32 limit

def _never_allocated(h, w):
    """The nine planes at h x w as stride-0 views of one element each."""
    f = torch.zeros(1).expand(h, w)
    b = torch.zeros(1, dtype=torch.bool).expand(h, w)
    return (f, b, f, f, f, b, f, f, b)


def _wrapper_call(name, planes, full_shape=None):
    cfg = config_from_reference(TrackerConfig())
    K = torch.eye(3)
    if name == "terms_launcher":
        return gn.terms_launcher(planes, K, 0, cfg, full_shape=full_shape)
    if name == "gn_terms":
        return gn.gn_terms(*planes, K, torch.eye(4), 0, cfg, full_shape=full_shape)
    return gn_level.gn_level(planes, K, torch.zeros(6), 0, cfg)


class _NoLibrary:
    def __getattr__(self, name):
        raise AssertionError(f"{name}: the wrapper reached the kernel library")


@pytest.mark.parametrize("route", ["plain", "cuda"])
@pytest.mark.parametrize("name", ["terms_launcher", "gn_terms", "gn_level"])
def test_gn_wrappers_refuse_the_float32_count_limit(name, route, monkeypatch):
    """At 2**24 pixels (4096 x 4096, planes that are never allocated) each
    GN wrapper raises ``gn.check_pixels``' ValueError before it reaches the
    library or the plain version; on the card's route, one pixel fewer
    passes the guard and is refused by the next check (the planes are not
    contiguous), not by it."""
    if route == "cuda":
        for mod in (gn, gn_level):
            monkeypatch.setattr(mod, "resolve_device", lambda _: "cuda")
        monkeypatch.setattr(_build, "library", _NoLibrary)
        monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
    assert 4096 * 4096 == gn.MAX_PIXELS
    with pytest.raises(ValueError, match="the count is summed in float32"):
        _wrapper_call(name, _never_allocated(4096, 4096))
    if name != "gn_level":   # a row block of a full image at the limit
        with pytest.raises(ValueError, match="the count is summed in float32"):
            _wrapper_call(name, _never_allocated(16, 4096), full_shape=(4096, 4096))
    if route == "cuda":
        with pytest.raises(ValueError, match="not contiguous"):
            _wrapper_call(name, _never_allocated(4096, 4095))
