"""The frozen work arithmetic reproduces the kernel table's bytes at the main
shapes, and the roofline readers stay at or under 100% on a trace whose
kernels take exactly their bound."""

from types import SimpleNamespace

import numpy as np
import pytest

from vobench import harness, work
from vobench.profiling import Trace


def test_gn_level_at_120x160():
    nbytes, _ = work.gn_level((120, 160), [], 15)
    assert nbytes == 518_668
    assert work.bound_s(nbytes, 0) == pytest.approx(0.155e-6, rel=2e-3)


def test_epipolar_fused_at_120x160():
    nbytes, flops = work.epipolar_fused((120, 160), 8, 0, 8)
    assert nbytes == 2_631_056
    assert work.bound_s(nbytes, flops) == pytest.approx(0.785e-6, rel=2e-3)


def test_frame_build_and_regularize_cull():
    assert work.framebuild((212, 256), 4, 3)[0] == 2_291_648
    assert work.regularize_cull((120, 160), 3)[0] == 355_200


def test_gn_level_operations_count_the_steps_that_ran():
    one = work.gn_level((30, 40), [1000], 15)[1]
    two = work.gn_level((30, 40), [1000, 900], 15)[1]
    assert two - one == 82 * 1200 + 97 * 900 + 700
    assert work.gn_level((30, 40), [1000, 900], 15)[0] == work.gn_level((30, 40), [], 15)[0]


def _ctx(cell, config, traffic, frames, kernel_us):
    sizes = [(30, 40), (60, 80), (120, 160)]
    vc = np.zeros((frames, 3, 15), np.int32)
    vc[:, :, 0] = [h * w for h, w in sizes]
    it = np.ones((frames, 3), np.int32)
    events, t = [], 0.0
    for _ in range(frames):
        for us in kernel_us:
            events.append(("void gn_level_kernel<8, 256>", t, t + us))
            t += us + 1.0
        events.append(("void epipolar_kernel", t, t + 0.785))
        t += 2.0
    trace = Trace(events, [], t * 1e-6, frames)
    # the untraced window: the same frames, 1.25 times the device time a frame
    run = SimpleNamespace(host={"valid_counts": vc, "iterations": it}, frames=frames,
                          window_s=1.25 * trace.union_s())
    return SimpleNamespace(run=run, trace=trace, config=config, traffic=traffic, cell=cell)


def test_rooflines_at_their_bound_read_100():
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, config, traffic, _, _ = harness.resolve(bench, "mono.offline", root)
    sizes = [(30, 40), (60, 80), (120, 160)]
    bound_us = [1e6 * work.bound_s(*work.gn_level(s, [s[0] * s[1]], 15)) for s in sizes]
    ctx = _ctx(cell, config, traffic, 4, bound_us)
    assert harness.reader("gn_level_roofline")(ctx) == pytest.approx(100.0, rel=1e-6)
    epi = harness.reader("epipolar_roofline")(ctx)
    assert 99.0 < epi <= 100.1
    assert 0 < harness.reader("step_mfu.offline")(ctx) < 100
    assert harness.reader("device_idle_pct.offline")(ctx) == pytest.approx(20.0)
    for name in ("gn_level_roofline", "step_mfu.offline", "device_idle_pct.offline",
                 "step_device_ops_per_frame", "gn_steps_per_frame"):
        twin = "device_idle_pct.rgbd" if name == "device_idle_pct.offline" else \
            "step_mfu.rgbd" if name == "step_mfu.offline" else name + ".rgbd"
        assert harness.reader(twin)(ctx) == harness.reader(name)(ctx)
    slow = _ctx(cell, config, traffic, 4, [10 * b for b in bound_us])
    assert harness.reader("gn_level_roofline")(slow) == pytest.approx(10.0, rel=1e-6)


def test_readers_find_nothing_without_a_trace():
    ctx = SimpleNamespace(run=SimpleNamespace(host={}, capture_s=None, frames=10, window_s=1.0),
                          trace=None, config={}, traffic={"streams": 1}, cell={})
    for name in ("gn_level_roofline", "epipolar_roofline", "step_mfu.offline",
                 "device_idle_pct.offline", "step_device_ops_per_frame",
                 "gn_steps_per_frame", "mapper_observed_px_per_frame",
                 "fleet_device_busy_us_per_frame", "gn_level_roofline.rgbd",
                 "step_mfu.rgbd", "device_idle_pct.rgbd"):
        assert harness.reader(name)(ctx) is None


def test_trace_union_and_gaps():
    t = Trace([("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0)],
              [("host op", 19.0, 35.0), ("outer", 0.0, 100.0)], 50e-6, 1)
    assert t.union_s() == pytest.approx(30e-6)
    assert t.gaps() == [["host op", pytest.approx(10e-6)]]
    assert t.top_ops(2)[0][0] == "b"
