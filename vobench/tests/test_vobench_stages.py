"""The stage readers (``vobench/stages.py``) on synthetic traces, and, on
the card (skipped here), the program's markers in a traced monocular
chunk at the cell's size: one marker at the start of each region on every
frame, each kernel in its own stage, and the untraced graph unchanged by
tracing."""

import json
from pathlib import Path

import pytest
import torch

from vobench import drivers, harness, profiling, program, stages
from vobench.profiling import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MONO = [f"{s}_device_us_per_frame" for s in ("frame_build", "track", "pose", "map", "copy")] \
    + ["pose_device_ops_per_frame", "issue_host_us_per_frame"]
NEW = MONO + [f"{m}.rgbd" for m in MONO if not m.startswith("map")] \
    + ["fleet_issue_host_us_per_frame"]
SEED = 2**31 + 77


def ctx(trace):
    from types import SimpleNamespace

    return SimpleNamespace(trace=trace)


# Two frames' worth of regions: frame_build 0-10 (a marker and one op),
# track 10-40 (two ops, a gap), end 40-55 (one op: no stage), copy 55-60,
# then track 60-90, whose last op ends the trace at 90.
EVENTS = [("dvo_stage_frame_build", 0, 1), ("build", 2, 9),
          ("dvo_stage_track", 10, 11), ("gn_level_kernel", 12, 20), ("fill", 25, 39),
          ("dvo_stage_end", 40, 41), ("upload", 45, 50),
          ("dvo_stage_copy", 55, 56), ("copy", 56, 58),
          ("dvo_stage_track", 60, 61), ("gn_level_kernel", 62, 90)]
STAGE_NAMES = ("frame_build", "track", "pose", "map", "copy", "end")


def test_regions_cut_at_markers():
    t = Trace(list(reversed(EVENTS)), [], 1.0, 2)
    assert stages.regions(t) == [("frame_build", 0, 10, 1, 7), ("track", 10, 40, 2, 22),
                                 ("end", 40, 55, 1, 5), ("copy", 55, 60, 1, 2),
                                 ("track", 60, 90, 1, 28)]


def test_stage_time_sums_to_the_busy_time():
    """The stages' busy time, the ``end`` regions' and the markers' add up
    to the window's device busy time (``Trace.union_s``); gaps count in no
    stage."""
    t = Trace(EVENTS, [], 1.0, 2)
    per = {s: stages.device_us_per_frame(ctx(t), s) for s in STAGE_NAMES}
    assert per == {"frame_build": 3.5, "track": 25.0, "pose": 0.0, "map": 0.0, "copy": 1.0,
                   "end": 2.5}
    markers = sum(e - s for name, s, e in EVENTS if name.startswith(stages.MARKER))
    assert sum(per.values()) * t.frames + markers == pytest.approx(t.union_s() * 1e6)


def test_overlapping_operations_count_once_and_in_their_region():
    """An op that overlaps the one before counts its new time only, and an
    op running past the next marker counts up to it."""
    t = Trace([("dvo_stage_pose", 0, 1), ("a", 1, 5), ("b", 3, 8), ("c", 7, 14),
               ("dvo_stage_map", 12, 13), ("d", 13, 15)], [], 1.0, 1)
    assert stages.regions(t) == [("pose", 0, 12, 3, 11), ("map", 12, 15, 1, 2)]


def test_markers_are_not_operations():
    t = Trace(EVENTS, [], 1.0, 2)
    ops = {s: stages.device_ops_per_frame(ctx(t), s) for s in ("frame_build", "track", "copy")}
    assert ops == {"frame_build": 0.5, "track": 1.5, "copy": 0.5}
    marked = sum(1 for name, _, _ in EVENTS if name.startswith(stages.MARKER))
    assert sum(r[3] for r in stages.regions(t)) == len(EVENTS) - marked
    # an operation before the first marker belongs to no region
    early = Trace([("fill", -5, -1)] + EVENTS, [], 1.0, 2)
    assert stages.regions(early) == stages.regions(t)


def test_host_span_time():
    host = [("dvo.issue", 0, 30), ("dvo.issue", 100, 110), ("dvo.stage.copy", 1, 2),
            ("dvo.issues", 0, 1000)]
    t = Trace(EVENTS, host, 1.0, 4)
    assert stages.host_us_per_frame(ctx(t), "issue") == 10.0
    assert stages.host_us_per_frame(ctx(t), "load") is None


@pytest.mark.parametrize("name", NEW)
def test_every_new_reader_reads_nothing_without_marks(name):
    """A trace with no marker and no span (the parent's program, or a
    fleet's markers left out) gives None: the metric is left out."""
    t = Trace([("gn_level_kernel", 0, 10), ("fill", 12, 13)], [("aten::fill_", 0, 1)], 1.0, 2)
    read = harness.reader(name)
    assert read(ctx(t)) is None and read(ctx(None)) is None


def test_stage_metrics_are_declared_for_their_cells():
    cells = {m["name"]: m["workloads"] for m in BENCH["per_layer"] if m["name"] in NEW}
    assert sorted(cells) == sorted(NEW)
    for name, where in cells.items():
        want = ("mono.fleet8" if name.startswith("fleet") else
                "rgbd.offline" if name.endswith(".rgbd") else "mono.offline")
        assert where == [want], name


# ------------------------------------------------------------------ the card

MONO_FRAME = ["copy", "end", "frame_build", "track", "pose", "map", "pose", "map", "pose",
              "copy", "end", "copy", "end"]
# where each kernel of the program may run, by a word of its name
KERNEL_STAGES = {"gn_level_kernel": {"track"}, "epipolar_kernel": {"map"},
                 "regularize_cull_kernel": {"map"}, "framebuild_kernel": {"frame_build"}}


def _mono(device):
    """The ``mono.offline`` cell's first state and a chunk call at its size."""
    _, config, traffic, _, _ = harness.resolve(BENCH, "mono.offline", ROOT)
    cfg = program.dvo_config(config)
    inp = drivers.make_inputs(config, traffic, SEED, device)
    n = traffic["chunk"]
    grays = inp.gray[:, :n].to(device)
    state = program.mono_init(inp.gray[:, -1].to(device), inp.mask, inp.K, cfg, inp.noise,
                              device)

    def chunk(st):
        out = program.mono_chunk(st, grays, inp.mask, inp.K, cfg, inp.resets[:, :n])
        program.sync(device)
        return out

    return state, chunk, n


def _leaves(res):
    return list(program.fields(res).values())


@pytest.mark.card
def test_traced_mono_chunk_marks_every_frame(card):
    state, chunk, n = _mono(card)
    state, _ = chunk(state)
    t = profiling.profiled(lambda: chunk(state), n)
    marks = [name[len(stages.MARKER):] for name, _, _ in sorted(t.device, key=lambda e: e[1])
             if name.startswith(stages.MARKER)]
    assert marks == ["frame_build", "end", "copy", "end"] + MONO_FRAME * n + ["copy", "end"]
    assert not [name for name, _, _ in t.device if name.startswith("dvo.")]
    cut = stages.regions(t)
    starts = [r[1] for r in cut]
    seen = {word: set() for word in KERNEL_STAGES}
    for name, s, _ in t.device:
        if name.startswith(stages.MARKER) or s < starts[0]:
            continue
        region = max(i for i, r in enumerate(starts) if r <= s)
        for word in KERNEL_STAGES:
            if word in name:
                seen[word].add(cut[region][0])
    assert seen == KERNEL_STAGES


@pytest.mark.card
def test_untraced_graph_is_unchanged_by_tracing(card):
    """The launches an untraced chunk replays are those of a driver built
    before the profiler ran, before and after a traced chunk and in a
    driver built after it; the traced copy's replays give the same bits."""
    from dvo_tpu_torch.ops.cuda import _build

    state, chunk, _ = _mono(card)
    state, _ = chunk(state)

    def launches(st):
        _build.reset_launches()
        out = chunk(st)
        return dict(_build.LAUNCHES), out

    before, (_, plain) = launches(state)
    unseen = _mono(card)[0]
    out = []
    # the second chunk's driver is built while the profiler records
    profiling.profiled(lambda: out.extend([chunk(state), chunk(unseen)]), 2)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(plain), _leaves(out[0][1])))
    assert launches(state)[0] == before
    assert launches(out[1][0])[0] == before
    fresh, _ = chunk(_mono(card)[0])
    assert launches(fresh)[0] == before
