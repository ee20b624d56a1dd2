"""The step's pose algebra (``dvo_tpu_torch.ops.cuda.pose``) on the CPU.

* Each entry on CPU tensors (its plain version) gives bit for bit what the
  step computed before it had the entry: the ``lie`` call sequence of
  ``monocular_step``/``rgbd_step`` and ``mapper.pose_table``'s old body
  (``OLD_POSE_TABLE``), on zero twists, rotations below 1e-6 rad, angles
  near pi, translations of several metres and a generic twist; the warm
  start's gate on both sides of its norm; ``need_kf`` both ways; rings of
  1 and 8 slots.
* The same against ``dvo_tpu.lie`` (JAX on the CPU) within 1e-5, relative
  and absolute, as ``test_torch_lie`` holds the two algebras (the near-pi
  case within 2e-5: the logarithm near pi amplifies the products' order).
* ``EmulatedPoseLibrary``: ``csrc/pose.cu``'s four C entries behind their
  ctypes arguments, each lane's chain transcribed scalar by scalar (its
  products and sums in the order the kernel takes them, which is the order
  the library takes them in on the card; fmaf emulated in double), drives
  the wrappers' launch route: within ``4e-6 * max(1, |plain|)`` of the
  plain versions (the card test's tolerance; near pi 2e-5, as against
  ``dvo_tpu``: the CPU's matmuls sum in yet another order), the 0/1 entries
  of the 4x4s and the table's unused columns exact, and a monocular step
  counting 3 launches and an RGB-D step 2.
* The wrappers refuse a wrong dtype, shape or device before the library.
"""

import ctypes
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu import lie as jlie
from dvo_tpu_torch import lie
from dvo_tpu_torch.config import DVOConfig
from dvo_tpu_torch.models import mapper
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.ops.cuda import _build, pose

from test_torch_gn_level import _arr
from test_torch_pose_card import (
    CASES,
    ENTRIES,
    NEAR_PI_TOL,
    PLAIN,
    call,
    last_row_exact,
    max_norm,
    table_inputs,
    table_zeros_exact,
    tol_of,
    twists,
    within,
)

torch.set_num_threads(1)

TOL = 1e-5


def OLD_POSE_TABLE(K, obj_xi_w, rel_xi, history):
    """``models.mapper.pose_table``'s body before ``ops/cuda/pose``."""
    c = history.capacity
    T = lie.se3_exp(torch.cat([obj_xi_w[None], -history.xi, rel_xi[None]]))
    T_rel = T[c + 1]
    r_xi = lie.se3_log(T[0] @ T[1:c + 1])
    T_es = lie.se3_exp(-r_xi)
    table = torch.zeros((2 + c, 16), dtype=torch.float32, device=K.device)
    table[0, :9] = K.reshape(9)
    table[1, :9] = T_rel[:3, :3].reshape(9)
    table[1, 9:12] = T_rel[:3, 3]
    table[1, 12] = rel_xi[2]
    table[2:, :9] = T_es[:, :3, :3].reshape(c, 9)
    table[2:, 9:12] = T_es[:, :3, 3]
    table[2:, 12:15] = -r_xi[:, :3]
    return table


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g, w)


# ----------------------------------------------- the plain versions, bitwise

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("entry,flag", ENTRIES)
def test_plain_entry_is_the_old_sequence_bit_for_bit(entry, flag, case):
    got, want = call(entry, flag, case, pose)
    _equal(got, want)
    _equal(call(entry, flag, case, PLAIN)[0], want)


@pytest.mark.parametrize("capacity", [1, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_table_is_the_old_pose_table_bit_for_bit(case, capacity):
    K, obj, rel, hist = table_inputs(case, capacity)
    want = OLD_POSE_TABLE(K, obj, rel, hist)
    _equal([mapper.pose_table(K, obj, rel, hist), pose.table_plain(K, obj, rel, hist.xi)],
           [want, want])


# ------------------------------------------------------ against dvo_tpu.lie

def _j(x):
    return jnp.asarray(x.numpy())


def _jax(entry, flag, case):
    """What ``dvo_tpu.lie`` gives for the entry's outputs."""
    a, b, p = (_j(x) for x in twists(case))
    if entry == "warm_mono":
        x = jlie.compose(a, b)
        gate = max_norm(torch.tensor(np.asarray(x)), flag)
        return [jnp.where(jnp.linalg.norm(x) < gate, x, 0.0)]
    if entry == "warm_rgbd":
        gate = max_norm(torch.tensor(np.asarray(b)), flag)
        return [jnp.where(jnp.linalg.norm(b) < gate, b, 0.0)]
    if entry == "track_mono":
        return [jlie.compose(a, b), jlie.compose(-p, b)]
    if entry == "track_rgbd":
        return [jlie.compose(a, b), jlie.se3_exp(jlie.compose(a, b))]
    pose_xi = p if flag else jlie.compose(a, b)
    return [jlie.se3_exp(pose_xi), jnp.zeros(6) if flag else b]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("entry,flag", ENTRIES)
def test_plain_entry_matches_dvo_tpu(entry, flag, case):
    got, _ = call(entry, flag, case, PLAIN)
    _close(got, _jax(entry, flag, case), NEAR_PI_TOL if case == "near_pi" else TOL)


@pytest.mark.parametrize("capacity", [1, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_table_matches_dvo_tpu(case, capacity):
    K, obj, rel, hist = table_inputs(case, capacity)
    r_xi = np.asarray(jlie.compose(_j(obj)[None], -_j(hist.xi)))
    T_rel = np.asarray(jlie.se3_exp(_j(rel)))
    T_es = np.asarray(jlie.se3_exp(-jnp.asarray(r_xi)))
    want = np.zeros((2 + capacity, 16), np.float32)
    want[0, :9] = K.numpy().reshape(9)
    want[1, :9], want[1, 9:12], want[1, 12] = T_rel[:3, :3].reshape(9), T_rel[:3, 3], rel[2]
    want[2:, :9] = T_es[:, :3, :3].reshape(capacity, 9)
    want[2:, 9:12], want[2:, 12:15] = T_es[:, :3, 3], -r_xi[:, :3]
    tol = NEAR_PI_TOL if case == "near_pi" else TOL
    np.testing.assert_allclose(pose.table_plain(K, obj, rel, hist.xi).numpy(), want,
                               rtol=tol, atol=tol)


# ------------------------------------------ csrc/pose.cu, scalar by scalar

SMALL = 1e-6


def f32(v):
    return torch.tensor(float(v), dtype=torch.float32)


def fma(a, b, c):
    """fmaf: one rounding of a b + c (the product is exact in double)."""
    return f32(float(a) * float(b) + float(c))


def dot3(batched, a0, b0, a1, b1, a2, b2):
    if batched:
        return fma(a2, b2, fma(a1, b1, a0 * b0))
    return fma(a1, b1, a0 * b0) + a2 * b2


def _theta(w):
    return torch.sqrt((w[0] * w[0] + w[2] * w[2]) + w[1] * w[1] + f32(1e-24))


def _hat(w):
    z = f32(0.0)
    return [[z, -w[2], w[1]], [w[2], z, -w[0]], [-w[1], w[0], z]]


def _square(batched, W):
    return [[dot3(batched, W[i][0], W[0][j], W[i][1], W[1][j], W[i][2], W[2][j])
             for j in range(3)] for i in range(3)]


def _eye_plus(a, W, b, W2):
    return [[(f32(1.0 if i == j else 0.0) + a * W[i][j]) + b * W2[i][j] for j in range(3)]
            for i in range(3)]


def _apply(A, x):
    return [dot3(False, A[i][0], x[0], A[i][1], x[1], A[i][2], x[2]) for i in range(3)]


def exp_scalar(batched, xi):
    """pose.cu se3_exp: (R, t)."""
    v, w = xi[:3], xi[3:]
    th = _theta(w)
    W = _hat(w)
    W2 = _square(batched, W)
    if th < SMALL:
        a, b, c = f32(1.0) - th * th / 6.0, f32(0.5) - th * th / 24.0, f32(1 / 6) - th * th / 120
    else:
        a = torch.sin(th) / th
        b = (f32(1.0) - torch.cos(th)) / (th * th)
        c = (th - torch.sin(th)) / (th * th * th)
    return _eye_plus(a, W, b, W2), _apply(_eye_plus(b, W, c, W2), v)


def log_scalar(batched, R, t):
    """pose.cu se3_log."""
    trace = (R[0][0] + R[1][1]) + R[2][2]
    cos_th = torch.clamp((trace - 1.0) * 0.5, min=f32(-0.9999999), max=f32(1.0))
    th0 = torch.arccos(cos_th)
    vee = [R[2][1] - R[1][2], R[0][2] - R[2][0], R[1][0] - R[0][1]]
    w = [f32(0.0)] * 3 if th0 < SMALL else [th0 / (2.0 * torch.sin(th0)) * v for v in vee]
    th = _theta(w)
    W = _hat(w)
    half = th * 0.5
    if th < SMALL:
        cot = f32(1.0) / 12.0 + th * th / 720.0
    else:
        cot = (f32(1.0) - half * torch.cos(half) / torch.sin(half)) / (th * th)
    return _apply(_eye_plus(f32(-0.5), W, cot, _square(batched, W)), t) + w


def _load(ptr, negate=False):
    return [f32(-v if negate else v) for v in _arr(ptr, (6,))]


def _compose(batched, a, b):
    """pose.cu compose: the 4x4 product with b's homogeneous row, then the
    logarithm."""
    Ra, ta = exp_scalar(batched, a)
    Rb, tb = exp_scalar(batched, b)
    cols = [[Rb[0][j], Rb[1][j], Rb[2][j], f32(0.0)] for j in range(3)] + [[*tb, f32(1.0)]]
    out = []
    for i in range(3):
        row = []
        for b0, b1, b2, b3 in cols:
            front = fma(Ra[i][1], b1, Ra[i][0] * b0)
            row.append(fma(ta[i], b3, fma(Ra[i][2], b2, front)) if batched
                       else front + fma(ta[i], b3, Ra[i][2] * b2))
        out.append(row)
    return log_scalar(batched, [r[:3] for r in out], [r[3] for r in out])


def _store(ptr, values):
    _arr(ptr, (len(values),))[:] = [float(v) for v in values]


def _exp4(xi):
    R, t = exp_scalar(False, xi)
    return [v for i in range(3) for v in (*R[i], t[i])] + [0.0, 0.0, 0.0, 1.0]


class EmulatedPoseLibrary:
    """``csrc/pose.cu``'s C entries behind their ctypes arguments: every
    lane's job in the kernel's order, writing every element of the
    outputs."""

    def dvo_pose_warm(self, a, b, xi0, gate, stream):
        x = _load(a) if b is None else _compose(False, _load(a), _load(b))
        sq = f32(0.0)
        for v in x:
            sq = sq + v * v
        keep = bool(torch.sqrt(sq) < f32(gate))
        _store(xi0, [v if keep else 0.0 for v in x])
        return 0

    def dvo_pose_track(self, ref_xi, rel_xi, prev_rel, frame_xi, vel, T_world, stream):
        if (prev_rel is None) != (vel is None):
            return 1
        rel = _load(rel_xi)
        out = _compose(False, _load(ref_xi), rel)
        _store(frame_xi, out)
        if T_world is not None:
            _store(T_world, _exp4(out))
        if vel is not None:
            _store(vel, _compose(False, _load(prev_rel, negate=True), rel))
        return 0

    def dvo_pose_table(self, K, obj_xi_w, rel_xi, hist_xi, table, capacity, stream):
        rows = _arr(table, (2 + capacity, 16))
        rows[0] = list(_arr(K, (9,))) + [0.0] * 7
        rel = _load(rel_xi)
        R, t = exp_scalar(True, rel)
        rows[1] = [float(v) for i in range(3) for v in R[i]] + [float(v) for v in t] + [
            float(rel[2]), 0.0, 0.0, 0.0]
        for c in range(capacity):
            inv = [f32(-v) for v in _arr(hist_xi + 24 * c, (6,))]
            xi = [-v for v in _compose(True, _load(obj_xi_w), inv)]
            R, t = exp_scalar(True, xi)
            rows[2 + c] = ([float(v) for i in range(3) for v in R[i]] + [float(v) for v in t]
                           + [float(v) for v in xi[:3]] + [0.0])
        return 0

    def dvo_pose_emit(self, need_kf, ref_xi, frame_xi, rel_xi, T_world, prev_rel, stream):
        kf = bool(_arr(need_kf, (1,), ctypes.c_bool)[0])
        _store(T_world, _exp4(_load(ref_xi if kf else frame_xi)))
        _store(prev_rel, [0.0] * 6 if kf else _load(rel_xi))
        return 0


@pytest.fixture
def launch_route(monkeypatch):
    """``ops/cuda/pose``'s wrappers on their launch route with CPU tensors,
    ``EmulatedPoseLibrary`` behind them."""
    monkeypatch.setattr(pose, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", EmulatedPoseLibrary)
    monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
    _build.reset_launches()
    yield
    _build.reset_launches()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("entry,flag", ENTRIES)
def test_launch_route_matches_the_plain_version(entry, flag, case, launch_route):
    got, _ = call(entry, flag, case, pose)
    want, _ = call(entry, flag, case, PLAIN)
    within(got, want, tol_of(case))
    for g in got:
        if g.shape == (4, 4):
            last_row_exact(g)
    if entry == "emit" and flag:
        assert torch.equal(got[1], torch.zeros(6))
    assert _build.LAUNCHES["pose"] == 1


@pytest.mark.parametrize("capacity", [1, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_launch_route_table_matches_the_plain_version(case, capacity, launch_route):
    K, obj, rel, hist = table_inputs(case, capacity)
    got = pose.table(K, obj, rel, hist.xi)
    want = pose.table_plain(K, obj, rel, hist.xi)
    within([got], [want], tol_of(case))
    table_zeros_exact(got)
    assert _build.LAUNCHES["pose"] == 1


def _rgbd_frames(n=4, h=48, w=64):
    from test_torch_rgbd import _sequence

    grays, masks, depths, sigmas, K = _sequence(h, w)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (grays[:n], masks[:n], depths[:n], sigmas[:n], K)]


def _mono_steps(n=4):
    from test_torch_odometry import TCFG, render_sequence, STEP

    frames, _, K = render_sequence(np.random.default_rng(0), n, 48, 64, STEP)
    grays = [torch.tensor(f[0]) for f in frames]
    masks = [torch.tensor(f[1]) for f in frames]
    K = torch.from_numpy(K)
    cfg = dataclasses.replace(TCFG, mapper=dataclasses.replace(TCFG.mapper, crop_x=(4, 59),
                                                                 crop_y=(4, 43), max_forward=2))
    state = todo.monocular_init(grays[0], masks[0], K, cfg, device="cpu",
                                noise=torch.zeros(48, 64))
    out = []
    for i in range(1, n):
        state, res = todo.monocular_step(state, grays[i], masks[i], K, cfg,
                                         reset_depth=torch.ones(48, 64))
        out.append(res)
    return out


def _rgbd_steps():
    g, m, d, s, K = _rgbd_frames()
    cfg = DVOConfig.rgbd()
    cfg = dataclasses.replace(cfg, pyramid=dataclasses.replace(cfg.pyramid, levels=2, culls=0))
    state = todo.rgbd_init(g[0], m[0], d[0], s[0], K, cfg, device="cpu")
    out = []
    for i in range(1, len(g)):
        state, res = todo.rgbd_step(state, g[i], m[i], d[i], s[i], K, cfg)
        out.append(res)
    return out


@pytest.mark.parametrize("path,per_frame", [("mono", 3), ("rgbd", 2)])
def test_steps_launch_the_pose_entries(path, per_frame, monkeypatch):
    """A monocular step launches ``track``, ``table`` and ``emit``, an RGB-D
    step ``warm`` and ``track``; no other counter moves (the other kernels
    take their plain versions here), and the poses stay within the card
    tolerance of the plain step's (a few frames: float noise compounds)."""
    steps = _mono_steps if path == "mono" else _rgbd_steps
    want = steps()
    monkeypatch.setattr(pose, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", EmulatedPoseLibrary)
    monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
    _build.reset_launches()
    got = steps()
    launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    assert launches == {**{k: 0 for k in launches}, "pose": per_frame * len(got)}
    for g, w in zip(got, want):
        last_row_exact(g.T_world)
        torch.testing.assert_close(g.T_world, w.T_world, rtol=0, atol=1e-5)
        assert torch.equal(g.is_keyframe, w.is_keyframe)


# ------------------------------------------------------ refused arguments

_TW = torch.zeros(6)
_REFUSED = [
    ("warm", lambda: pose.warm(_TW.double(), 1.0), "vel: dtype"),
    ("warm", lambda: pose.warm(_TW, 1.0, prev_rel=torch.zeros(7)), "prev_rel: shape"),
    ("track", lambda: pose.track(torch.zeros(6, device="meta"), _TW), "ref_xi: on meta"),
    ("track", lambda: pose.track(_TW, _TW, prev_rel=torch.zeros(12)[::2]), "prev_rel: not contig"),
    ("table", lambda: pose.table(torch.eye(3).reshape(9), _TW, _TW, torch.zeros(8, 6)), "K: shape"),
    ("table", lambda: pose.table(torch.eye(3), _TW, _TW, torch.zeros(6, 8).T), "hist_xi: not"),
    ("table", lambda: pose.table(torch.eye(3), _TW, _TW, torch.zeros(0, 6)), "C >= 1"),
    ("table", lambda: pose.table(torch.eye(3).half(), _TW, _TW, torch.zeros(8, 6)), "K: dtype"),
    ("emit", lambda: pose.emit(torch.tensor(1), _TW, _TW, _TW), "need_kf: dtype"),
    ("emit", lambda: pose.emit(torch.tensor([True]), _TW, _TW, _TW), "need_kf: shape"),
    ("emit", lambda: pose.emit(torch.tensor(True), _TW, _TW.half(), _TW), "frame_xi: dtype"),
]


@pytest.mark.parametrize("entry,refused,match", _REFUSED)
def test_wrappers_refuse_what_the_kernel_does_not_take(entry, refused, match, monkeypatch):
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(pose, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", no_library)
    with pytest.raises(ValueError, match=match):
        refused()
