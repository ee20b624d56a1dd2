"""The offline loop of a monocular configuration with windowed bundle
adjustment: the chunked loop's run (``chunked.run``: one stream, chunks
from pinned memory into the graphed driver, closed loop), and a judge that
holds the program's BA as well as its step.

The chunked loop drains each frame's pose, twist, decision and tracking
counts, not BA's outputs, and a solve rewrites up to seven poses and depth
maps of the ring that a later solve of the same chunk rewrites again.  So
for each judged chunk the judge first steps the program once more, frame by
frame, from its state before the chunk through the same captured step
(``program.mono_chunk`` on one frame at a time), and holds that replay to
the timed chunk bit for bit: every drained output of every frame and the
state after the chunk (``rerun_gap``, 0 when equal).  The replay's
``StepResult`` and its state after each frame are then the timed path's
BA: the final cost, the window's poses, and the ring's poses and depths
after the write-back.

The plain reference (``reference/ba.py``) then follows the chunk from the
program's state before it, as the monocular judge does (``judge.py``): at
each frame it tracks the frame itself (``cost_excess``,
``first_residual_gap``), steps with the program's twist (``pose_gap``,
``keyframe_flips``, ``observed_gap``), and on each promotion whose window
is full solves BA on its own window and holds the program's solve to it:

* ``ba_pose_gap``: the largest difference of the window's poses, the
  program's ``StepResult`` and its ring after the write-back both;
* ``ba_motion_gap``: the same for the window's motions relative to its
  oldest keyframe (rotation and translation entries), the program's
  translations scaled by the one factor that fits them best to the
  reference's: monocular BA leaves the window's scale to its damping
  alone, so float noise moves it (``motion_gap``);
* ``ba_depth_off_share``: of the window's pixels that either solve moved
  (by more than ``judge.MAP_TOL`` relative), the share whose depth in the
  program's ring differs from the reference's by more than
  ``BA_DEPTH_TOL`` relative;
* ``ba_cost_gap``: the final iteration's cost, relative;
* ``ba_cost_excess``: how far the window's cost (``reference/ba.cost``)
  at the program's poses and depths lies above the one at the
  reference's, relative: noise moves a solution along the cost's flat
  directions, a wrong one costs more;
* ``ba_motion_gap_median``, ``ba_cost_excess_median``: the median of each
  over the judged solves;
* ``ba_condition``: the largest condition number of a judged window's
  damped reduced system (``reference/ba.condition``), the witness of how
  far float32 rounding alone moves a solve;
* ``ba_flips``: frames on which one side solved and the other did not.

After each solve it goes on from the program's poses and depths, as it
goes on from the program's twists.  The reduced systems reach condition
numbers of ~1.5e9 at the cell's size, so float32 rounding alone moves a
solve of an ill-conditioned window, now and then, as far as TF32 does:
the worst of a run (``ba_pose_gap``, ``ba_motion_gap``,
``ba_depth_off_share``, ``ba_cost_gap``, ``ba_cost_excess``) is a
reading.  The cell's limits name the typical solve
(``ba_motion_gap_median``) and ``ba_flips``.  ``map_off_share`` holds the
reference keyframe's maps at the chunk's end.  ``ba_unchecked`` is 1
where no judged chunk held a solve.  With ``control`` the reference in
TF32 takes the program's place (its own tracking, step and BA), and no
replay is made.

One stream: the replay steps one state.
"""

from __future__ import annotations

import dataclasses
import statistics

import torch

from vobench import program
from vobench.judge import (MAP_TOL, Readings, map_off_share, mono_state, precision,
                           start_gap_mono)
from vobench.loops import chunked
from vobench.reference import ba, dvo, lie

run = chunked.run

# Per-pixel depth tolerance of a solve: |a - b| <= BA_DEPTH_TOL * (1 + |b|).
# The damped Schur solve amplifies float noise: on the rig's windows two
# float32 computations of one solve (the program's targets batched and its
# own double loop) part by 1.5e-4 on the poses after five iterations, and
# by more than 1e-4 on nearly every moved depth but by more than 1e-2 on
# 0.4% of them (CPU, 60x80 base).
BA_DEPTH_TOL = 1e-2


def _check(traffic: dict) -> None:
    if traffic["streams"] != 1:
        raise ValueError(f"the chunked_ba judge replays one stream, not {traffic['streams']}")


def _gap(a, b) -> float:
    """The largest difference of two tensors: float, int or bool."""
    if a.shape != b.shape:
        return float("inf")
    if not a.numel():
        return 0.0
    return float((a.double() - b.double()).abs().max())


def _leaves(tree) -> list:
    """Every tensor of a program state, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return []


def replay(sample, inp, cfg, n: int, r: Readings) -> list:
    """Step the program one frame at a time through the judged chunk from its
    state before it; worst ``rerun_gap`` against the timed chunk.  Returns
    per frame the drained outputs, ``ba_cost``, ``ba_xi`` (the window's
    poses of its ``StepResult``) and ``after`` (its state after the frame,
    as the reference reads it)."""
    dev = inp.K.device
    state, frames = sample.before, []
    for i in range(n):
        k = sample.chunk * n + i
        state, res = program.mono_chunk(state, inp.gray[0, k].to(dev)[None, None], inp.mask,
                                        inp.K, cfg, inp.resets[0, k][None, None])
        out = {key: v[0] for key, v in program.fields(res).items()}
        r.worst("rerun_gap", max(_gap(v, sample.outputs[key][i]) for key, v in out.items()))
        frames.append(dict(out, ba_cost=res.ba_cost[0], ba_xi=res.ba_window_xi[0],
                           after=mono_state(state)))
    r.worst("rerun_gap", max(_gap(a, b) for a, b in zip(_leaves(state), _leaves(sample.after)))
            if len(_leaves(state)) == len(_leaves(sample.after)) else float("inf"))
    return frames


def control_frames(st: dvo.MonoState, frames, cfg, mask, K) -> list:
    """The reference in the program's place: its own tracking, step and BA,
    in the records ``replay`` gives."""
    out = []
    for gray, reset in frames:
        st, o = ba.mono_step(st, gray, mask, K, cfg, reset)
        solved = o["ba"]
        out.append({"T_world": o["T_world"], "rel_xi": o["rel_xi"],
                    "is_keyframe": o["is_keyframe"], "observed": o["observed"],
                    "residuals": o["tracking"]["residuals"],
                    "ba_cost": solved[2][-1] if solved else torch.tensor(-1.0),
                    "ba_xi": solved[0] if solved else None, "after": st})
    return out


def _off(a, b, tol):
    return (a - b).abs() > tol * (1.0 + b.abs())


def _moved_off(got, want, start) -> float:
    """Of the pixels that either solve moved off ``start``, the share on
    which the two differ beyond ``BA_DEPTH_TOL``."""
    moved = _off(got, start, MAP_TOL) | _off(want, start, MAP_TOL)
    return float((_off(got, want, BA_DEPTH_TOL) & moved).sum()) / max(int(moved.sum()), 1)


def motion_gap(xi_got, xi_want) -> float:
    """The largest difference of two windows' motions relative to their
    oldest keyframe, ``xi_got``'s translations scaled to fit ``xi_want``'s
    best (least squares)."""
    def motions(xi):
        T = lie.se3_exp(xi.double())
        rel = torch.linalg.inv(T[0]) @ T
        return rel[:, :3, :3], rel[:, :3, 3]

    R_got, t_got = motions(xi_got)
    R_want, t_want = motions(xi_want)
    scale = (t_got * t_want).sum() / torch.clamp((t_got * t_got).sum(), min=1e-30)
    return max(float((R_got - R_want).abs().max()), float((scale * t_got - t_want).abs().max()))


def judge_frames(st: dvo.MonoState, frames, recs, cfg, mask, K, r: Readings,
                 track_every: int = 1, solves: list = None) -> int:
    """Follow ``frames`` from ``st`` with the program's records ``recs``
    (``replay``); returns the solves held.  Each held solve's motion gap and
    cost excess are appended to ``solves``."""
    tc, pc, m = cfg.tracker, cfg.pyramid, cfg.ba.window
    held = 0
    for i, ((gray, reset), o) in enumerate(zip(frames, recs)):
        if i % track_every == 0:
            obj = dvo.build_frame(gray, mask, K, pc.levels, pc.culls, st.frame_count)
            own = dvo.track(obj, st.ref, tc, dvo.mono_xi0(st, tc))
            c_prog, _ = dvo.mean_residual(obj, st.ref, o["rel_xi"], tc)
            c_own, _ = dvo.mean_residual(obj, st.ref, own["xi"], tc)
            r.worst("cost_excess", (c_prog - c_own) / torch.clamp(c_own, min=1e-12))
            first = own["residuals"][0, 0]
            r.worst("first_residual_gap", (o["residuals"][0, 0] - first).abs()
                    / torch.clamp(first.abs(), min=1e-12))
        program_solved = float(o["ba_cost"]) >= 0.0

        def hold(win):
            nonlocal held
            xi, depth, costs = ba.bundle_adjust(win, cfg.ba)
            if not program_solved:
                return xi, depth, costs
            held += 1
            ring = o["after"].ring
            s = torch.tensor(ba.slots(ring, m), device=ring.xi.device)
            got_xi, got_depth = ring.xi[s], ring.depth[s]
            r.worst("ba_pose_gap", max(_gap(got_xi, xi), _gap(o["ba_xi"], xi)))
            gap = max(motion_gap(got_xi, xi), motion_gap(o["ba_xi"], xi))
            r.worst("ba_motion_gap", gap)
            r.worst("ba_condition", ba.condition(win, cfg.ba))
            r.worst("ba_depth_off_share", _moved_off(got_depth, depth, win.depth))
            r.worst("ba_cost_gap", abs(float(o["ba_cost"]) - float(costs[-1]))
                    / max(abs(float(costs[-1])), 1e-12))
            c_own = float(ba.cost(win, xi, depth, cfg.ba))
            excess = (float(ba.cost(win, got_xi, got_depth, cfg.ba)) - c_own) / max(abs(c_own),
                                                                                   1e-12)
            r.worst("ba_cost_excess", excess)
            if solves is not None:
                solves.append((gap, excess))
            return got_xi, got_depth, costs

        st, out = ba.mono_step(st, gray, mask, K, cfg, reset, tracked_xi=o["rel_xi"],
                               solve=hold)
        r.add("ba_flips", program_solved != (out["ba"] is not None))
        r.worst("pose_gap", _gap(o["T_world"], out["T_world"]))
        r.add("keyframe_flips", bool(o["is_keyframe"]) != out["is_keyframe"])
        r.worst("observed_gap", abs(int(o["observed"]) - out["observed"])
                / max(out["observed"], 1))
    r.worst("map_off_share", map_off_share(recs[-1]["after"].ref, st.ref))
    return held


def judge(config: dict, traffic: dict, run, control: bool = False) -> Readings:
    """Every number over the run's judged chunks (module docstring)."""
    _check(traffic)
    cfg = dvo.namespace(config["dvo"])
    inp = run.inputs
    dev = inp.K.device
    n, M = traffic["chunk"], traffic["period"]
    r = Readings()
    held, solves = 0, []
    with precision(False):
        want = dvo.mono_init(inp.gray[0, M - 1].to(dev), inp.mask, inp.K, cfg, inp.noise[0])
        r.worst("start_gap", start_gap_mono(mono_state(run.first), want))
        for s in run.samples:
            st = mono_state(s.before)
            frames = [(inp.gray[0, s.chunk * n + i].to(dev), inp.resets[0, s.chunk * n + i])
                      for i in range(n)]
            if control:
                with precision(True):
                    recs = control_frames(st, frames, cfg, inp.mask, inp.K)
            else:
                recs = replay(s, inp, program.dvo_config(config), n, r)
            held += judge_frames(st, frames, recs, cfg, inp.mask, inp.K, r,
                                 traffic.get("check_track_every", 1), solves)
    if solves:
        r.values["ba_motion_gap_median"] = statistics.median(gap for gap, _ in solves)
        r.values["ba_cost_excess_median"] = statistics.median(excess for _, excess in solves)
    r.values.setdefault("rerun_gap", 0.0)
    r.values["ba_unchecked"] = float(held == 0)
    return r
