"""Windowed BA on the monocular step, on the CPU: the program's
``bundle_adjust`` against the benchmark's plain reference
(``vobench/reference/ba.py``, which imports nothing of the program) on
seeded random windows of 7 keyframes at 24x32; a graphed chunk with BA
(the driver's CPU protocol) followed and judged by the benchmark's BA judge
(``vobench/loops/chunked_ba.py``) at a small rig size, solves included;
the BA-off step untouched by BA's machinery; the ``ba`` stage where a
solve runs.

Tolerances.  The damped reduced system of these windows has a condition
number of 0.7-1.7e6 (measured), so the order of float32 sums moves its
solution: the program's batched targets and its own double loop part by
up to 1.8e-4 on one step's twists and 2.2e-3 after five, and the
reference, which sums pair by pair, by up to 2.6e-4 and 4.8e-3 (measured,
seeds 0-3).  So the first cost, which no solve has touched yet, is held
within 1e-6 relative (measured 0-1.2e-7); one step's twists within 1e-3
and its depths within 1e-2 relative (measured 4e-3); five steps' twists
within 1e-2, and their solution by the reference's cost: the cost at the
program's poses and depths within 3% of the one at the reference's
(measured -1.0% to +0.9%: the two land on either side along the cost's
flat directions).  The windows start 1.9e-2 to 5.6e-2 from the
reference's solution on the twists, so the twists' tolerance alone would
pass a solve that moved little: five steps must also close at least three
quarters of that distance (the program's leave 0.8-8.3% of it, measured)."""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvo_tpu_torch.config import BAConfig
from dvo_tpu_torch.models import ba as tba
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.ops.cuda import _build
from vobench.reference import ba as rba

from test_ba import _make_window
from test_torch_graphed import CFG, _mono_init, same, sequence  # noqa: F401

torch.set_num_threads(1)
SEEDS = [0, 1, 2, 3]
FIRST_COST_TOL = 1e-6
STEP_XI_TOL = 1e-3
STEP_DEPTH_TOL = 1e-2
SOLVE_XI_TOL = 1e-2
SOLVE_COST_TOL = 0.03
SOLVE_LEFT = 0.25          # of the start's distance to the reference's twists


def _windows(seed):
    jw, _ = _make_window(np.random.default_rng(seed), m=7, h=24, w=32, pose_noise=0.003,
                         depth_noise=0.02)
    pw = tba.window_from_reference(jax.tree.map(np.asarray, jw), "cpu")
    rw = rba.Window(pw.gray, pw.mask, pw.gx, pw.gy, pw.gmask, pw.depth, pw.xi, pw.K)
    return pw, rw


def _plain(cfg: BAConfig) -> SimpleNamespace:
    """The configuration as the reference reads it (the file's ``ba`` dict)."""
    return SimpleNamespace(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("seed", SEEDS)
def test_one_step_matches_the_reference(seed):
    pw, rw = _windows(seed)
    cfg = BAConfig(iterations=1)
    got = tba.bundle_adjust(pw, cfg)
    xi, depth, costs = rba.bundle_adjust(rw, _plain(cfg))
    np.testing.assert_allclose(got.costs.numpy(), costs.numpy(), rtol=FIRST_COST_TOL)
    np.testing.assert_allclose(got.xi.numpy(), xi.numpy(), rtol=0, atol=STEP_XI_TOL)
    assert (got.xi - pw.xi).abs().max() > 4 * STEP_XI_TOL        # the step moved the poses
    rel = (got.depth - depth).abs() / (1.0 + depth.abs())
    assert rel.max() < STEP_DEPTH_TOL, rel.max()


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_matches_the_reference(seed):
    """Five iterations (``BAConfig``'s): the first cost, the twists, how far
    the twists moved toward the reference's, and the solution's cost on the
    reference's yardstick."""
    pw, rw = _windows(seed)
    cfg = BAConfig()
    got = tba.bundle_adjust(pw, cfg)
    xi, depth, costs = rba.bundle_adjust(rw, _plain(cfg))
    assert got.costs.shape == costs.shape == (5,)
    np.testing.assert_allclose(got.costs[0].item(), costs[0].item(), rtol=FIRST_COST_TOL)
    np.testing.assert_allclose(got.xi.numpy(), xi.numpy(), rtol=0, atol=SOLVE_XI_TOL)
    assert (got.xi - xi).abs().max() < SOLVE_LEFT * (pw.xi - xi).abs().max()
    own = rba.cost(rw, xi, depth, _plain(cfg))
    assert abs(rba.cost(rw, got.xi, got.depth, _plain(cfg)) / own - 1.0) < SOLVE_COST_TOL
    assert own < costs[0]                                           # the solve lowered it


def test_window_slots_are_gathered_on_the_device():
    """The window's slots come from the ring's head and count on the device,
    as the reference's host ints give them, for a wrapped ring and one that
    holds fewer keyframes than the window."""
    from test_torch_ba import _ring

    for pushes, m in ((6, 3), (6, 4), (2, 3), (7, 5)):
        hist, _ = _ring("torch", pushes=pushes)
        ring = SimpleNamespace(head=int(hist.head), count=int(hist.count),
                               capacity=hist.capacity)
        slots = tba.window_slots(hist, m)
        assert slots.dtype == torch.int64 and slots.device == hist.head.device
        assert slots.tolist() == rba.slots(ring, m)


def _ba_cfg(window=2, iterations=1):
    return dataclasses.replace(CFG, ba=dataclasses.replace(CFG.ba, enabled=True, window=window,
                                                           iterations=iterations))


def test_ba_off_step_never_enters_the_region(sequence, monkeypatch):
    """Without BA the step issues no conditional region, and its results are
    bitwise those of a step whose BA is never due (a window larger than the
    ring): BA's machinery adds nothing to the BA-off path."""
    grays, masks, K, _, resets = sequence
    st_never, res_never = todo.monocular_run(_mono_init(sequence), grays[1:9], masks[1:9], K,
                                             _ba_cfg(window=CFG.mapper.history_capacity + 1),
                                             resets[:8])
    assert (res_never.ba_cost < 0).all()

    def refuse(*args, **kwargs):
        raise AssertionError("the BA-off step entered a conditional region")

    monkeypatch.setattr(_build, "when", refuse)
    st_off, res_off = todo.monocular_run(_mono_init(sequence), grays[1:9], masks[1:9], K, CFG,
                                         resets[:8])
    assert res_off.ba_window_xi.shape == (8, 0, 6)
    strip = lambda r: dataclasses.replace(r, ba_cost=r.ba_cost * 0,
                                          ba_window_xi=r.ba_window_xi[:, :0])
    assert same(strip(res_off), strip(res_never)) and same(st_off, st_never)


def test_when_runs_the_body_only_where_due():
    """On the CPU ``when`` reads the bool and runs the body where it holds;
    the body's puts land in its destinations, nothing else changes."""
    dst = torch.zeros(3)
    calls = []

    def body(put):
        calls.append(1)
        put(dst, torch.arange(3.0))

    _build.when(torch.tensor(False), body, "ba")
    assert not calls and torch.equal(dst, torch.zeros(3))
    _build.when(torch.tensor(True), body, "ba")
    assert calls == [1] and torch.equal(dst, torch.arange(3.0))


def test_ba_stage_marks_each_solve(sequence):
    """Traced (the CPU profiler), the step's ``ba`` stage opens once a solve,
    inside ``map``, and on no frame without one."""
    grays, masks, K, _, resets = sequence
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, res = todo.monocular_run(_mono_init(sequence), grays[1:9], masks[1:9], K, _ba_cfg(),
                                    resets[:8])
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    solves = int((res.ba_cost >= 0).sum())
    assert solves > 0 and names.count("dvo.stage.ba") == solves


def test_graphed_ba_chunk_follows_the_reference():
    """The benchmark's ``mono.ba`` cell at a small size on the CPU: chunks of
    16 over a 64-frame path through the graphed driver's CPU protocol, one
    judged chunk, followed by the plain reference frame by frame with the
    BA judge: the replay equals the timed chunk, at least one full-window
    solve is held, and every number is within the cell's limits.  The
    limits hold the median solve of a run (some eight on the card); the
    judged chunk holds several (the 7-keyframe ring fills by frame 33),
    where a chunk of 8 holds one, whose median is its worst."""
    import json
    from pathlib import Path

    from vobench import harness

    root = Path(__file__).resolve().parents[1]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, config, traffic, _, _ = harness.resolve(bench, "mono.ba", root)
    traffic = dict(traffic, chunk=16, period=64, check_chunks=1)
    run = harness.run_cell(cell, config, traffic, 2**31 + 5, 0.0, False, device="cpu",
                           shape=(240, 320))
    correct, rows = harness.judge(cell, config, traffic, run)
    values = {name: value for name, value, _ in rows}
    assert values["ba_unchecked"] == 0.0 and values["rerun_gap"] == 0.0
    assert correct, rows


@pytest.mark.parametrize("seed", SEEDS)
def test_reduced_system_condition(seed):
    """The witness behind the tolerances above: the damped reduced system of
    each window, as the reference builds it, has a condition number between
    1e5 and 1e7 (0.7-1.7e6 measured)."""
    _, rw = _windows(seed)
    assert 1e5 < rba.condition(rw, _plain(BAConfig())) < 1e7


def test_motion_gap_leaves_out_the_scale():
    """The BA judge's ``ba_motion_gap``: a window whose translations are all
    scaled about its oldest keyframe reads no gap; one keyframe moved reads
    that move."""
    from vobench.loops.chunked_ba import motion_gap
    from vobench.reference import lie as rlie

    pw, _ = _windows(0)
    T = rlie.se3_exp(pw.xi)
    rel = torch.linalg.inv(T[0]) @ T
    scaled = rel.clone()
    scaled[:, :3, 3] *= 1.3
    xi_scaled = rlie.se3_log(T[0] @ scaled)
    assert motion_gap(xi_scaled, pw.xi) < 1e-5
    moved = pw.xi.clone()
    moved[3, 0] += 0.01
    assert 0.005 < motion_gap(moved, pw.xi) < 0.02
