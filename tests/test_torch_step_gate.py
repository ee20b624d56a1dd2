"""The per-frame gate (``dvo_tpu_torch.tools.step_gate``) that
``chip_smoke.py`` holds the card's monocular steps to: one step from a
state against the same step from a CPU copy of that state.  Here both sides
run on the CPU, on the reduced slice of ``tests/test_torch_odometry.py``:
the gate holds on two runs of the same step, and it fails when the "card"
side's pose moves by 1e-4, its keyframe decision flips, its depth map moves,
or BA ran on one side only or elsewhere; the CPU step with the card's
tracking holds the mapper where the card's tracker is off, the CPU's own
tracking catches that tracker where it converged."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import MAP_SHARE, MAP_VALUE_TOL, POSE_TOL
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.tools import step_gate

from test_odometry import render_sequence
from test_torch_odometry import CFG, H, N, STEP, TCFG, W

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rig():
    frames, depth, K = render_sequence(np.random.default_rng(0), N, H, W, STEP)
    grays = torch.tensor(np.stack([f[0] for f in frames]))
    masks = torch.tensor(np.stack([f[1] for f in frames]))
    K = torch.tensor(K)
    resets = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 2.0, (N - 1, H, W))
                              .astype(np.float32))
    start = todo.monocular_init(grays[0], masks[0], K, TCFG, device="cpu",
                                noise=torch.from_numpy(np.random.default_rng(2).standard_normal(
                                    (H, W)).astype(np.float32)))
    step = lambda st, i: todo.monocular_step(st, grays[1 + i], masks[1 + i], K, TCFG, resets[i])
    return start, step


@pytest.fixture(scope="module")
def mid(rig):
    """The state three frames in (after a promotion and depth updates), and
    its next step run twice."""
    start, step = rig
    state = start
    for i in range(3):
        state, _ = step(state, i)
    return state, step(state, 3), step(step_gate.on_device(state, "cpu"), 3)


def _gate(card, cpu):
    return step_gate.compare_step(3, card, cpu, POSE_TOL, MAP_VALUE_TOL, MAP_SHARE)


def test_gate_holds_on_the_same_step(mid):
    _, card, cpu = mid
    r = _gate(card, cpu)
    assert r.ok and r.dT == 0.0 and r.keyframe[0] == r.keyframe[1]
    assert r.depth == (1.0, 0.0) and r.sigma == (1.0, 0.0) and r.ba is None


def test_gate_fails_on_a_moved_pose(mid):
    _, (state, res), cpu = mid
    moved = dataclasses.replace(res, T_world=res.T_world + torch.tensor(1e-4))
    r = _gate((state, moved), cpu)
    assert not r.ok and any("T_world" in f for f in r.failures)
    assert r.dT == pytest.approx(1e-4, rel=1e-3)


def test_gate_fails_on_a_flipped_decision(mid):
    _, (state, res), cpu = mid
    flipped = dataclasses.replace(res, is_keyframe=~res.is_keyframe)
    r = _gate((state, flipped), cpu)
    assert not r.ok and any("keyframe" in f for f in r.failures)


def test_gate_fails_on_a_moved_map(mid):
    _, (state, res), cpu = mid
    base = state.ref.base
    depth = base.depth.clone()
    depth.view(-1)[::50] += 1e-3     # 2% of the pixels
    ref = dataclasses.replace(state.ref, scenes=(*state.ref.scenes[:-1],
                                                 dataclasses.replace(base, depth=depth)))
    r = _gate((dataclasses.replace(state, ref=ref), res), cpu)
    assert not r.ok and any(f.startswith("depth") for f in r.failures)
    assert r.depth[0] == pytest.approx(0.98, abs=0.005)


@pytest.mark.parametrize("case", ["one side", "window", "cost"])
def test_gate_holds_ba_steps(mid, case):
    """A step that ran BA: the window's poses within the pose tolerance,
    both costs within the cost tolerance, BA on both sides."""
    _, (state, res), (cpu_state, cpu_res) = mid
    xi = torch.zeros(4, 6)
    with_ba = lambda r, cost, window: dataclasses.replace(
        r, ba_cost=torch.tensor(cost), ba_window_xi=window)
    card = with_ba(res, 10.0, xi)
    cpu = with_ba(cpu_res, 10.0, xi)
    assert _gate((state, card), (cpu_state, cpu)).ok
    if case == "one side":
        card = with_ba(res, -1.0, xi)
    elif case == "window":
        card = with_ba(res, 10.0, xi + 1e-4)
    else:
        card = with_ba(res, 11.0, xi)
    r = _gate((state, card), (cpu_state, cpu))
    assert not r.ok and r.ba is not None


def _gates(start, card, cpu, **kw):
    return step_gate.per_frame_gates(start, range(N - 1), card, cpu,
                                     TCFG.tracker.max_iterations, POSE_TOL, MAP_VALUE_TOL,
                                     MAP_SHARE, **kw)


def test_per_frame_gates_hold_a_run(rig):
    """Every frame of a run against its CPU copy, with the card's tracking,
    and with its own where the tracker converged: no failure; the card
    side's results are the eager loop's; both mapping branches gated."""
    start, step = rig
    last, results, readings = _gates(start, step, step)
    tracked, own = (step_gate.summary(readings[c]) for c in ("card's tracking", "own tracking"))
    assert tracked["frames"] == list(range(N - 1)) and not tracked["failed"]
    assert tracked["max_dT"] == 0.0 and tracked["min_depth_share"] == 1.0
    assert own["frames"] == [i for i, r in enumerate(results)
                             if step_gate.converged(r, TCFG.tracker.max_iterations)]
    assert own["frames"] and not own["failed"] and own["max_dT"] == 0.0
    kf = [r.keyframe[0] for r in readings["card's tracking"]]
    assert any(kf) and not all(kf)
    state = start
    for i, res in enumerate(results):
        state, want = step(state, i)
        assert torch.equal(res.T_world, want.T_world)
    assert torch.equal(last.ref.base.depth, state.ref.base.depth)


def test_per_frame_gates_find_the_wrong_frame(rig):
    """A card step whose pose is off by 1e-4 on one frame fails that frame,
    and only that frame (each gate starts from the card's own state)."""
    start, step = rig

    def card(st, i):
        st, res = step(st, i)
        if i == 2:
            res = dataclasses.replace(res, T_world=res.T_world + torch.tensor(1e-4))
        return st, res

    _, _, readings = _gates(start, card, step)
    assert list(step_gate.summary(readings["card's tracking"])["failed"]) == [2]


def test_own_tracking_catches_a_wrong_tracker(rig):
    """A card whose tracker is off by 1e-4 on every level: the CPU step with
    the card's tracking agrees with it (the mapper took the same pose), the
    CPU's own tracking does not, on every frame where the card converged."""
    from dvo_tpu_torch.models import tracker

    start, step = rig
    real = tracker.gn_level

    def card(st, i):
        tracker.gn_level = lambda *a: (real(*a)[0] + 1e-4, *real(*a)[1:])
        try:
            return step(st, i)
        finally:
            tracker.gn_level = real

    _, _, readings = _gates(start, card, step)
    tracked, own = (step_gate.summary(readings[c]) for c in ("card's tracking", "own tracking"))
    assert not tracked["failed"]
    assert own["frames"] and list(own["failed"]) == own["frames"]


def test_tracked_as_replaces_the_tracker(rig, mid):
    """Inside ``tracked_as`` a step's tracking is the given result, so its
    twist is that result's xi; outside it the step tracks again."""
    _, step = rig
    state, (_, res), _ = mid
    moved = dataclasses.replace(res.tracking, xi=res.tracking.xi + 1e-3)
    with step_gate.tracked_as(moved):
        _, got = step(state, 3)
    assert torch.equal(got.relative_xi, moved.xi)
    assert torch.equal(step(state, 3)[1].relative_xi, res.relative_xi)
    assert torch.equal(got.tracking.iterations, res.tracking.iterations)


def test_gate_only_where_asked(rig):
    start, step = rig
    _, results, readings = _gates(start, step, step, gate=lambda i, res: bool(res.is_keyframe))
    assert [r.frame for r in readings["card's tracking"]] == [
        i for i, r in enumerate(results) if bool(r.is_keyframe)]


def test_on_device_copies_a_state(mid):
    state, _, _ = mid
    copy = step_gate.on_device(state, "cpu")
    assert copy.generator is not state.generator
    for a, b in zip(dataclasses.astuple(copy.ref.scenes[-1]),
                    dataclasses.astuple(state.ref.scenes[-1])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert torch.equal(copy.history.depth, state.history.depth)
    assert int(copy.frame_count) == int(state.frame_count)
    assert CFG.mapper.history_capacity == copy.history.capacity
