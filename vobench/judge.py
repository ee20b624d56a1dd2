"""Whether what the timed path produced is correct: the program's outputs
held against the plain reference (``vobench/reference``), after the window.

A monocular trajectory follows float noise: the depth update's gates are
discrete and the coarsest GN level may not converge, so two computations of
one sequence part after some frames however right each step is.  The
reference therefore follows the program frame by frame from the program's
own state: for each judged chunk (drawn from the seed) it starts from the
program's state before the chunk and, at each frame,

* tracks the frame itself from that state (its own GN loop) and judges the
  program's pose by the reference's photometric cost: ``cost_excess`` is
  how far the reference's mean squared residual at the program's pose lies
  above the one at its own pose, on the base level, so a pose the noise
  moved along the cost's valley passes and a wrong one does not;
  ``first_residual_gap`` compares the first GN step of the coarsest level,
  which starts from the same twist on both sides (frame build, warp and
  residual);
* steps with the program's pose as its tracker's result: the world pose
  (``pose_gap``), the keyframe decision (``keyframe_flips``) and the
  mapper's observations (``observed_gap``);

and at the chunk's end holds the program's state against the one it
followed: the reference keyframe's depth, sigma and age maps
(``map_off_share``).  The program's first state is held against the
reference's own (``start_gap``).  RGB-D frames are tracked frame to frame
with no map: the reference builds both frames from the raw inputs and
tracks with the program's previous twist as the warm start, so the pose
and the GN iterations compare directly (``xi_gap``, ``iterations_gap``).

Every number is the worst over the judged frames; ``correct`` holds when
each number that the cell's limits file (``vobench/limits/<cell>.json``)
names is within its limit there.  A loop (``vobench/loops``) gathers its
judged chunks and calls these.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from vobench.reference import dvo, lie

# Per-pixel map tolerance: |a - b| <= MAP_TOL * (1 + |b|).
MAP_TOL = 1e-4

@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in float32 (TF32 off) or in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _pick(b):
    return (lambda t: t) if b is None else (lambda t: t[b])


def mono_state(st, b=None) -> dvo.MonoState:
    """The reference's view of a program ``VOState`` (stream ``b`` of a
    stack), read by attribute: the program's own state, nothing derived."""
    g = _pick(b)
    h = st.history
    ring = dvo.Ring(**{k: g(getattr(h, k)) for k in ("gray", "mask", "gx", "gy", "gmask",
                                                     "depth", "sigma", "xi", "kf_id")},
                    head=int(g(h.head)), count=int(g(h.count)))
    return dvo.MonoState(ring, frame(st.ref, g), int(g(st.frame_count)), g(st.prev_rel),
                         g(st.vel))


def frame(f, g=lambda t: t) -> dvo.Frame:
    levels = tuple(dvo.Level(*(None if getattr(s, k) is None else g(getattr(s, k))
                               for k in ("gray", "mask", "depth", "sigma", "gx", "gy",
                                         "gmask", "K")))
                   for s in f.scenes)
    return dvo.Frame(levels, g(f.xi), g(f.relative_xi), g(f.age), int(g(f.frame_id)))


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _off_share(a, b) -> torch.Tensor:
    a, b = a.float(), b.float()
    return (a - b).abs() > MAP_TOL * (1.0 + b.abs())


def map_off_share(got: dvo.Frame, want: dvo.Frame) -> float:
    """Share of base pixels whose depth, sigma or age differ."""
    off = _off_share(got.base.depth, want.base.depth) | _off_share(got.base.sigma,
                                                                    want.base.sigma)
    off = off | (got.age != want.age)
    return float(off.float().mean())


def start_gap_mono(got: dvo.MonoState, want: dvo.MonoState) -> float:
    """The first keyframe: its pyramid's gray, depth and sigma and the ring's
    first slot."""
    gaps = [_max_abs(a, b) for la, lb in zip(got.ref.levels, want.ref.levels)
            for a, b in ((la.gray, lb.gray), (la.depth, lb.depth), (la.sigma, lb.sigma))]
    s = want.ring.head
    gaps += [_max_abs(got.ring.depth[s], want.ring.depth[s]),
             _max_abs(got.ring.gray[s], want.ring.gray[s])]
    return max(gaps)


def start_gap_frame(got: dvo.Frame, want: dvo.Frame) -> float:
    return max(_max_abs(a, b) for la, lb in zip(got.levels, want.levels)
               for a, b in ((la.gray, lb.gray), (la.depth, lb.depth), (la.sigma, lb.sigma)))


@dataclasses.dataclass
class Readings:
    """The worst of each number over the judged frames."""
    values: dict = dataclasses.field(default_factory=dict)

    def worst(self, name: str, value: float) -> None:
        self.values[name] = max(self.values.get(name, 0.0), float(value))

    def add(self, name: str, value: float) -> None:
        self.values[name] = self.values.get(name, 0.0) + float(value)


def judge_mono_frames(st: dvo.MonoState, frames, outs, after, cfg, mask, K, r: Readings,
                      track_every: int = 1):
    """Follow ``frames`` (each (gray, reset plane)) from ``st`` with the
    program's per-frame outputs ``outs`` (dicts of device tensors), then hold
    the program's state ``after`` (a ``dvo.MonoState``) against the one
    followed.  The reference tracks every ``track_every``-th frame itself."""
    tc, pc = cfg.tracker, cfg.pyramid
    for i, ((gray, reset), o) in enumerate(zip(frames, outs)):
        if i % track_every == 0:
            obj = dvo.build_frame(gray, mask, K, pc.levels, pc.culls, st.frame_count)
            own = dvo.track(obj, st.ref, tc, dvo.mono_xi0(st, tc))
            c_prog, _ = dvo.mean_residual(obj, st.ref, o["rel_xi"], tc)
            c_own, _ = dvo.mean_residual(obj, st.ref, own["xi"], tc)
            r.worst("cost_excess", (c_prog - c_own) / torch.clamp(c_own, min=1e-12))
            first = own["residuals"][0, 0]
            r.worst("first_residual_gap", (o["residuals"][0, 0] - first).abs()
                    / torch.clamp(first.abs(), min=1e-12))
        st, out = dvo.mono_step(st, gray, mask, K, cfg, reset, tracked_xi=o["rel_xi"])
        r.worst("pose_gap", _max_abs(o["T_world"], out["T_world"]))
        r.add("keyframe_flips", bool(o["is_keyframe"]) != out["is_keyframe"])
        r.worst("observed_gap", abs(int(o["observed"]) - out["observed"])
                / max(out["observed"], 1))
    r.worst("map_off_share", map_off_share(after.ref, st.ref))


def judge_rgbd_frames(prev: dvo.Frame, world_xi, vel, frames, outs, cfg, r: Readings):
    """Track each of ``frames`` (reference frames built from the raw inputs)
    against the one before it, warm-started from the program's previous
    twist, and compose the program's twists onto ``world_xi``."""
    for f, o in zip(frames, outs):
        own = dvo.rgbd_track(prev, f, vel, cfg)
        r.worst("xi_gap", _max_abs(o["rel_xi"], own["xi"]))
        r.worst("iterations_gap", int((o["iterations"].cpu().long()
                                       - own["iterations"].cpu().long()).abs().sum()))
        first = own["residuals"][0, 0]
        r.worst("first_residual_gap", (o["residuals"][0, 0] - first).abs()
                / torch.clamp(first.abs(), min=1e-12))
        world_xi = lie.compose(world_xi, o["rel_xi"])
        r.worst("pose_gap", _max_abs(o["T_world"], lie.se3_exp(world_xi)))
        vel, prev = o["rel_xi"], f


def verdict(limits: dict, readings: Readings):
    """(correct, [(name, value, limit)]) over the numbers that ``limits``
    (the cell's ``vobench/limits/<cell>.json``) names: each within its
    limit, none missing or NaN."""
    rows = [(name, readings.values.get(name), limit) for name, limit in limits.items()]
    correct = all(v is not None and v == v and v <= lim for _, v, lim in rows)
    return correct, rows


def control_mono(st, frames, cfg, mask, K):
    """The reference in the program's place: its own tracking and step."""
    outs = []
    for gray, reset in frames:
        st, out = dvo.mono_step(st, gray, mask, K, cfg, reset)
        t = out["tracking"]
        outs.append({"T_world": out["T_world"], "rel_xi": out["rel_xi"],
                     "is_keyframe": out["is_keyframe"], "observed": out["observed"],
                     "residuals": t["residuals"], "iterations": t["iterations"]})
    return outs, st


def control_rgbd(prev, world_xi, vel, frames, cfg):
    outs = []
    for f in frames:
        t = dvo.rgbd_track(prev, f, vel, cfg)
        world_xi = lie.compose(world_xi, t["xi"])
        outs.append({"rel_xi": t["xi"], "iterations": t["iterations"],
                     "residuals": t["residuals"], "T_world": lie.se3_exp(world_xi)})
        vel, prev = t["xi"], f
    return outs
