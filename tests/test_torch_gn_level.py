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
* The ``work()`` byte and operation counts of all five kernels at 120x160
  and the bound they give.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu import lie as jlie
from dvo_tpu.config import TrackerConfig
from dvo_tpu.models import tracker as jtracker
from dvo_tpu_torch import lie as tlie
from dvo_tpu_torch.config import MapperConfig, config_from_reference
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


# ------------------------------------------------------ work() and the bound

@pytest.mark.parametrize("name,got,want", [
    ("gn", lambda: gn.work((120, 160)), (518656, 4012800)),
    ("gn_valid", lambda: gn.work((120, 160), 8431), (518656, 2645137)),
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
    assert by == "bytes" and us == pytest.approx(1e6 * 518656 / 3.35e12)
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
