"""Per-frame gates: one monocular step on the card against the same step on
the CPU from the same state.

A monocular trajectory follows float noise: the depth update's gates and
BA's validity and Huber gates are discrete, so a coordinate that moves by
an ulp can flip a pixel, and the flip grows over the frames after it.  Two
runs whose kernels sum in another order therefore drift apart however
right each step is.  These gates hold each step instead: for every frame,
the card's state before it is copied to the CPU, and the step runs there
on the same frame and reset plane (the plain versions).

Inside one step the tracker can follow float noise too: a pyramid level
whose GN loop does not converge and runs to ``max_iterations`` may
oscillate (on the noise-bootstrapped rig the coarsest level's residual
alternates between two values, and a difference of an ulp grows tenfold a
step), and the pose it stops at is then the noise's.  So a frame is held
twice (``CHECKS``):

* ``"own tracking"``: the CPU step as it is, where the card's tracker
  converged at every level before ``max_iterations``;
* ``"card's tracking"``: the CPU step with the card's ``TrackResult`` in
  place of its own (``tracked_as``), at every frame: the keyframe policy,
  the mapper (promotion, depth update, BA) and the regulariser from the
  same pose.

Each compares ``T_world`` within a pose tolerance, the keyframe decision,
the reference's base depth and sigma within a per-pixel tolerance on a
share of the pixels and, on a step that ran BA, the window's poses within
the pose tolerance and both costs within a relative tolerance.

``chip_smoke.py`` drives ``per_frame_gates`` on the noise-bootstrapped
monocular rig (every frame, and the steps with BA) and prints the
readings; ``tests/test_torch_step_gate.py`` drives it on the CPU;
``tools/rig_noise --per-frame`` rehearses it with the tracker's xi moved by
noise.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from dvo_tpu_torch.models.graphed import tree_map

CHECKS = ("own tracking", "card's tracking")


def on_device(state, device):
    """A copy of a state (``VOState`` or ``RGBDState``) on ``device``; a
    ``VOState`` gets a new generator there, seeded 0 (the gated steps take
    their reset planes as inputs and draw nothing)."""
    device = torch.device(device)
    moved = tree_map(lambda t: t.to(device, copy=True), state)
    if hasattr(moved, "generator"):
        moved = dataclasses.replace(moved, generator=torch.Generator(device=device).manual_seed(0))
    return moved


@contextlib.contextmanager
def tracked_as(tracking):
    """``monocular_step`` takes ``tracking`` (a ``TrackResult``, moved to the
    step's device) as its tracker's result instead of tracking."""
    from dvo_tpu_torch.models import odometry

    real = odometry.track
    odometry.track = lambda obj, ref, cfg, xi0=None: tree_map(
        lambda t: t.to(ref.xi.device, copy=True), tracking)
    try:
        yield
    finally:
        odometry.track = real


def converged(result, max_iterations: int) -> bool:
    """Whether a step's tracker stopped by its convergence test at every
    level (fewer than ``max_iterations`` steps at each)."""
    return bool((result.tracking.iterations < max_iterations).all())


def map_agreement(got, want, tol: float):
    """(share of pixels with |got - want| <= tol * (1 + |want|), max abs
    error), in float64 on the CPU: ``chip_smoke.compare_maps``' measure."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    err = (got - want).abs()
    return (err <= tol * (1.0 + want.abs())).double().mean().item(), err.max().item()


@dataclasses.dataclass
class Reading:
    """One frame's gate: what was compared and what failed (empty: held)."""

    frame: int
    dT: float                      # max |T_world card - T_world cpu|
    keyframe: tuple                # (card, cpu)
    depth: tuple                   # (share within tolerance, max abs error)
    sigma: tuple
    ba: dict = None                # a step that ran BA: window xi and cost readings
    failures: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def compare_step(frame: int, card, cpu, pose_tol: float, map_tol: float, map_share: float,
                 cost_tol: float = 5e-2) -> Reading:
    """Hold one step's outputs (``card`` and ``cpu``: (state', StepResult) of
    the same step from the same state) against each other."""
    (s_a, r_a), (s_b, r_b) = card, cpu
    dT = (r_a.T_world.detach().cpu() - r_b.T_world.detach().cpu()).abs().max().item()
    kf = (bool(r_a.is_keyframe), bool(r_b.is_keyframe))
    depth = map_agreement(s_a.ref.base.depth, s_b.ref.base.depth, map_tol)
    sigma = map_agreement(s_a.ref.base.sigma, s_b.ref.base.sigma, map_tol)
    out = Reading(frame, dT, kf, depth, sigma)
    if not dT <= pose_tol:
        out.failures.append(f"T_world differs by {dT:.3g} (tol {pose_tol})")
    if kf[0] != kf[1]:
        out.failures.append(f"keyframe decision card {kf[0]}, cpu {kf[1]}")
    for name, (share, err) in (("depth", depth), ("sigma", sigma)):
        if share < map_share:
            out.failures.append(f"{name}: {share:.5f} of pixels within {map_tol} "
                                f"(max error {err:.3g}), need {map_share}")
    cost_a, cost_b = float(r_a.ba_cost), float(r_b.ba_cost)
    if cost_a >= 0 or cost_b >= 0:
        d_xi = (r_a.ba_window_xi.detach().cpu() - r_b.ba_window_xi.detach().cpu()).abs()
        rel = abs(cost_a - cost_b) / max(abs(cost_b), 1e-6)
        out.ba = dict(window_dxi=d_xi.max().item(), cost=(cost_a, cost_b), cost_rel=rel)
        if cost_a < 0 or cost_b < 0:
            out.failures.append(f"BA ran on one side only: costs {cost_a}, {cost_b}")
        else:
            if not out.ba["window_dxi"] <= pose_tol:
                out.failures.append(f"BA window xi differs by {out.ba['window_dxi']:.3g} "
                                    f"(tol {pose_tol})")
            if not rel <= cost_tol:
                out.failures.append(f"BA cost {cost_a} vs {cost_b}: {rel:.3g} relative "
                                    f"(tol {cost_tol})")
    return out


def per_frame_gates(state, frames, card_step, cpu_step, max_iterations: int, pose_tol: float,
                    map_tol: float, map_share: float, cost_tol: float = 5e-2,
                    gate=lambda i, result: True):
    """Run ``card_step(state, i)`` -> (state', result) over ``frames`` (an
    iterable of frame indices) from ``state``.  On each frame for which
    ``gate(i, card result)`` holds, ``cpu_step(copy, i)`` runs on a CPU copy
    of the state before it (taken before the card step): with the card's
    tracking (``tracked_as``) always, and with its own where the card's
    tracker converged at every level (``converged``); each is held by
    ``compare_step``.  Returns (the card's last state, its results in
    order, {check: readings} for each of ``CHECKS``)."""
    results, readings = [], {name: [] for name in CHECKS}
    for i in frames:
        before = on_device(state, "cpu")
        state, res = card_step(state, i)
        results.append(res)
        if not gate(i, res):
            continue
        card = (state, res)
        with tracked_as(res.tracking):
            tracked = cpu_step(before, i)
        readings[CHECKS[1]].append(compare_step(i, card, tracked, pose_tol, map_tol,
                                                map_share, cost_tol))
        if converged(res, max_iterations):
            readings[CHECKS[0]].append(compare_step(i, card, cpu_step(before, i), pose_tol,
                                                    map_tol, map_share, cost_tol))
    return state, results, readings


def summary(readings) -> dict:
    """The worst reading of each kind over a list of readings, and the
    frames that failed with why."""
    if not readings:
        return dict(frames=[], failed={})
    ba = [r.ba for r in readings if r.ba is not None]
    return dict(
        frames=[r.frame for r in readings],
        max_dT=max(r.dT for r in readings),
        keyframes_equal=all(r.keyframe[0] == r.keyframe[1] for r in readings),
        min_depth_share=min(r.depth[0] for r in readings),
        max_depth_err=max(r.depth[1] for r in readings),
        min_sigma_share=min(r.sigma[0] for r in readings),
        max_sigma_err=max(r.sigma[1] for r in readings),
        ba_frames=[r.frame for r in readings if r.ba is not None],
        max_ba_window_dxi=max((b["window_dxi"] for b in ba), default=None),
        max_ba_cost_rel=max((b["cost_rel"] for b in ba), default=None),
        failed={r.frame: r.failures for r in readings if r.failures},
    )
