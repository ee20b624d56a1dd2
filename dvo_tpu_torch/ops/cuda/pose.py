"""The step's pose algebra: the CUDA kernel ``csrc/pose.cu`` through its
four entries, the plain PyTorch version of each, and the wrappers that pick
one by device.

Replaces no TPU kernel: ``dvo_tpu`` leaves this algebra (``dvo_tpu/lie.py``
as the step calls it) to XLA, which fuses it under ``jit``.  Eager on the
card it was one launch an op, some 60-70 ops a ``se3_exp`` or ``se3_log``.
Its work is a few twists and 4x4s and a few thousand float operations, so
it is bound by the launch floor, not by bytes or flops.  Its design is one
launch for each of the step's ``pose`` regions (``utils/trace``):

* ``warm``  — the warm start, ``where(|x| < max_norm, x, 0)`` with ``x`` the
  velocity (RGB-D) or ``compose(prev_rel, vel)`` (mono);
* ``track`` — after tracking: the frame's world twist ``compose(ref_xi,
  rel_xi)``, and the velocity ``compose(-prev_rel, rel_xi)`` (mono) or
  ``T_world`` (RGB-D);
* ``table`` — ``models.mapper.pose_table``'s (2 + C, 16) table;
* ``emit``  — after the mapper (mono): ``T_world`` of the emitted pose and
  the next ``prev_rel``.

Each plain version is the ``dvo_tpu_torch.lie`` call sequence the step made
before, verbatim, so CPU tensors give the same bits.  CUDA tensors launch or
raise.  Every launch adds one to ``_build.LAUNCHES["pose"]``: a mono frame
launches ``track``, ``table`` and ``emit`` (``warm`` too with
``cfg.tracker.warm_start``), an RGB-D frame ``warm`` and ``track``.  The
kernel computes every 3x3 product as an explicit sum in one fixed order, the
plain version through batched matmuls: the two differ by a few ulps.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import resolve_device
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.cuda.epipolar import TABLE_ROW

# Float operations counted one each (a sine, a cosine, an arccosine and a
# square root as one): se3_exp (the angle 7, hat's negations 3, W^2 45, the
# coefficients 13, I + aW + bW^2 twice 72, V v 15), se3_log (so3_log 16,
# the angle 7, hat 3, W^2 45, the cotangent term 8, V^-1 36, V^-1 t 15),
# compose (two exponentials, the 3x3 product 45, R t and the sum 18, a log).
EXP_FLOPS = 155
LOG_FLOPS = 130
COMPOSE_FLOPS = 2 * EXP_FLOPS + 45 + 18 + LOG_FLOPS
TWIST_BYTES = 6 * 4
T_BYTES = 16 * 4


def work(entry: str, capacity: int = 8, mono: bool = True):
    """(bytes, float operations) of one launch of ``entry``: the twists,
    matrices and table read and written once, and the operations above;
    ``capacity``: the ring's rows (``table``); ``mono``: the monocular form
    of ``warm`` and ``track``."""
    norm = 6 + 5 + 1
    if entry == "warm":
        return (4 if mono else 2) * TWIST_BYTES, (COMPOSE_FLOPS if mono else 0) + norm + 1
    if entry == "track":
        if mono:
            return 5 * TWIST_BYTES, 2 * COMPOSE_FLOPS + 6
        return 3 * TWIST_BYTES + T_BYTES, COMPOSE_FLOPS + EXP_FLOPS
    if entry == "table":
        c = int(capacity)
        nbytes = 9 * 4 + (2 + c) * TWIST_BYTES + 4 * TABLE_ROW * (2 + c)
        return nbytes, EXP_FLOPS + c * (COMPOSE_FLOPS + 12 + EXP_FLOPS)
    if entry == "emit":
        return 1 + 4 * TWIST_BYTES + T_BYTES, EXP_FLOPS
    raise ValueError(f"no pose entry {entry!r}")


def _twist(t, name, dev) -> None:
    _build.require(t, name, torch.float32, (6,), dev)


def _launch(name: str, *args) -> None:
    code = getattr(_build.library(), "dvo_pose_" + name)(*args)
    _build.check(code, "pose " + name)
    _build.LAUNCHES["pose"] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


# --------------------------------------------------------------------- warm

def warm_plain(vel, max_norm: float, prev_rel=None):
    if prev_rel is None:
        return torch.where(torch.linalg.vector_norm(vel) < max_norm, vel, 0.0)
    xi0 = lie.compose(prev_rel, vel)
    return torch.where(torch.linalg.vector_norm(xi0) < max_norm, xi0, 0.0)


def warm(vel, max_norm: float, prev_rel=None):
    """The warm start's twist: ``vel`` (RGB-D, ``prev_rel`` None) or
    ``compose(prev_rel, vel)`` (mono), kept where its norm is below
    ``max_norm`` and zero elsewhere.  (6,)."""
    if resolve_device(vel) == "plain":
        return warm_plain(vel, max_norm, prev_rel)
    dev = vel.device
    _twist(vel, "vel", dev)
    if prev_rel is not None:
        _twist(prev_rel, "prev_rel", dev)
    xi0 = torch.empty(6, dtype=torch.float32, device=dev)
    a, b = (vel, None) if prev_rel is None else (prev_rel, vel)
    _launch("warm", a.data_ptr(), _ptr(b), xi0.data_ptr(), float(max_norm),
            _build.stream_handle(dev))
    return xi0


# -------------------------------------------------------------------- track

def track_plain(ref_xi, rel_xi, prev_rel=None, world: bool = False):
    xi = lie.compose(ref_xi, rel_xi)
    vel = None if prev_rel is None else lie.compose(-prev_rel, rel_xi)
    return xi, vel, lie.se3_exp(xi) if world else None


def track(ref_xi, rel_xi, prev_rel=None, world: bool = False):
    """After tracking: (the frame's world twist ``compose(ref_xi,
    rel_xi)``, the velocity ``compose(-prev_rel, rel_xi)`` or None without
    ``prev_rel``, ``T_world = se3_exp`` of the world twist (4, 4) with
    ``world`` or None)."""
    if resolve_device(rel_xi) == "plain":
        return track_plain(ref_xi, rel_xi, prev_rel, world)
    dev = rel_xi.device
    for name, t in (("ref_xi", ref_xi), ("rel_xi", rel_xi), ("prev_rel", prev_rel)):
        if t is not None:
            _twist(t, name, dev)
    xi = torch.empty(6, dtype=torch.float32, device=dev)
    vel = None if prev_rel is None else torch.empty(6, dtype=torch.float32, device=dev)
    T = torch.empty((4, 4), dtype=torch.float32, device=dev) if world else None
    _launch("track", ref_xi.data_ptr(), rel_xi.data_ptr(), _ptr(prev_rel), xi.data_ptr(),
            _ptr(vel), _ptr(T), _build.stream_handle(dev))
    return xi, vel, T


# -------------------------------------------------------------------- table

def table_plain(K, obj_xi_w, rel_xi, hist_xi):
    c = hist_xi.shape[0]
    # One exp for the three twists that need one: the object frame's pose,
    # the ring's inverse poses and the relative pose (eager PyTorch pays per
    # op, not per row).
    T = lie.se3_exp(torch.cat([obj_xi_w[None], -hist_xi, rel_xi[None]]))
    T_rel = T[c + 1]
    r_xi = lie.se3_log(T[0] @ T[1:c + 1])                # compose(obj_xi_w, -xi): (C, 6)
    T_es = lie.se3_exp(-r_xi)                            # (C, 4, 4)
    table = torch.zeros((2 + c, TABLE_ROW), dtype=torch.float32, device=K.device)
    table[0, :9] = K.reshape(9)
    table[1, :9] = T_rel[:3, :3].reshape(9)
    table[1, 9:12] = T_rel[:3, 3]
    table[1, 12] = rel_xi[2]
    table[2:, :9] = T_es[:, :3, :3].reshape(c, 9)
    table[2:, 9:12] = T_es[:, :3, 3]
    table[2:, 12:15] = -r_xi[:, :3]
    return table


def table(K, obj_xi_w, rel_xi, hist_xi):
    """``models.mapper.pose_table``'s (2 + C, 16) table from ``K`` (3, 3),
    the object frame's world twist, the relative twist and the ring's
    twists ``hist_xi`` (C, 6)."""
    if resolve_device(rel_xi) == "plain":
        return table_plain(K, obj_xi_w, rel_xi, hist_xi)
    dev = rel_xi.device
    c = hist_xi.shape[0] if hist_xi.dim() else 0
    if c < 1:
        raise ValueError(f"hist_xi: shape {tuple(hist_xi.shape)}, expected (C, 6) with C >= 1")
    _build.require(K, "K", torch.float32, (3, 3), dev)
    _twist(obj_xi_w, "obj_xi_w", dev)
    _twist(rel_xi, "rel_xi", dev)
    _build.require(hist_xi, "hist_xi", torch.float32, (c, 6), dev)
    out = torch.empty((2 + c, TABLE_ROW), dtype=torch.float32, device=dev)
    _launch("table", K.data_ptr(), obj_xi_w.data_ptr(), rel_xi.data_ptr(), hist_xi.data_ptr(),
            out.data_ptr(), c, _build.stream_handle(dev))
    return out


# --------------------------------------------------------------------- emit

def emit_plain(need_kf, ref_xi, frame_xi, rel_xi):
    return lie.se3_exp(torch.where(need_kf, ref_xi, frame_xi)), torch.where(need_kf, 0.0, rel_xi)


def emit(need_kf, ref_xi, frame_xi, rel_xi):
    """After the mapper: (``T_world = se3_exp`` of ``ref_xi`` on a promotion
    and of ``frame_xi`` otherwise, (4, 4); the next ``prev_rel``: zero on a
    promotion, ``rel_xi`` otherwise).  ``need_kf``: a () bool tensor on the
    device, read there."""
    if resolve_device(rel_xi) == "plain":
        return emit_plain(need_kf, ref_xi, frame_xi, rel_xi)
    dev = rel_xi.device
    _build.require(need_kf, "need_kf", torch.bool, (), dev)
    for name, t in (("ref_xi", ref_xi), ("frame_xi", frame_xi), ("rel_xi", rel_xi)):
        _twist(t, name, dev)
    T = torch.empty((4, 4), dtype=torch.float32, device=dev)
    prev_rel = torch.empty(6, dtype=torch.float32, device=dev)
    _launch("emit", need_kf.data_ptr(), ref_xi.data_ptr(), frame_xi.data_ptr(),
            rel_xi.data_ptr(), T.data_ptr(), prev_rel.data_ptr(), _build.stream_handle(dev))
    return T, prev_rel
