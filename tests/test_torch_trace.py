"""The port's tracing (``dvo_tpu_torch/utils/trace.py``) on the CPU: with
no profiler recording it is one shared no-op; under ``torch.profiler`` a
chunk shows its spans (``dvo.chunk`` holding the cull, the load, the issue
loop and the unload) and each frame its stages in step order; with markers
on (a card's one-stream chunk, here with the launches recorded) every
frame enqueues the same markers, one at the start of each region; and the
outputs and state are bitwise those of an untraced chunk."""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvo_tpu_torch import run as tcli
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.utils import trace

from test_torch_cli import cli, write_sequence, write_yaml
from test_torch_graphed import CFG, RGBD_CFG, _mono_init, same, sequence  # noqa: F401

torch.set_num_threads(1)

# culled once: the chunk's cull has work to do
RGBD_CULLED = dataclasses.replace(RGBD_CFG, pyramid=dataclasses.replace(RGBD_CFG.pyramid,
                                                                         culls=1))
FRAMES = 3
KINDS = ["mono", "rgbd", "rgbd_raw"]

# Stage ranges a frame, by start: the input copy, the step, the state's
# copy-back, the results' copy (mono: warm start off, the pose table nested
# in the map stage).
FRAME_STAGES = {
    "mono": ["copy", "frame_build", "track", "pose", "map", "pose", "pose", "copy", "copy"],
    "rgbd": ["copy", "frame_build", "pose", "track", "pose", "copy", "copy"],
}
# Markers a frame: a nested stage marks its parent again when it ends; each
# copy ends with the end marker.
FRAME_MARKERS = {
    "mono": ["copy", "end", "frame_build", "track", "pose", "map", "pose", "map", "pose",
             "copy", "end", "copy", "end"],
    "rgbd": ["copy", "end", "frame_build", "pose", "track", "pose", "copy", "end", "copy",
             "end"],
}


def _chunk(kind, seq):
    """A fresh first state and one chunk of FRAMES frames: (state', results)."""
    grays, masks, K, depth0, resets = seq
    g, m = grays[1:FRAMES + 1], masks[1:FRAMES + 1]
    if kind == "mono":
        return todo.monocular_run(_mono_init(seq), g, m, K, CFG, resets[:FRAMES])
    depths = torch.stack([depth0 - 0.002 * k for k in range(FRAMES + 1)])
    sigmas = torch.full_like(depths, 0.1)
    state = todo.rgbd_init(grays[0], masks[0], depths[0], sigmas[0], K, RGBD_CULLED,
                           device="cpu")
    d, s = depths[1:], sigmas[1:]
    if kind == "rgbd":
        return todo.rgbd_run(state, g, m, d, s, K, RGBD_CULLED)
    counts = torch.round(d * 5000.0).to(torch.int32)
    return todo.rgbd_run_raw(state, g, m, counts, K, RGBD_CULLED, 5000.0, 0.1)


def _profiled(fn):
    """``fn()`` under the CPU profiler: (its result, the profiler's (name,
    start ns, end ns) in start order, read from its raw events, which is
    fast where ``prof.events()`` takes seconds)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()), key=lambda ev: ev[1])
    return out, events


def _within(events, outer):
    _, start, end = outer
    return [ev for ev in events if start <= ev[1] and ev[2] <= end and ev is not outer]


@pytest.fixture
def launches(monkeypatch):
    """Markers on wherever a chunk would mark them on a card, each launch
    recorded by name instead of enqueued."""
    marked = []
    monkeypatch.setattr(trace, "_can_mark", lambda device: True)
    monkeypatch.setattr(trace, "_load", lambda: None)
    monkeypatch.setattr(trace, "_launch", lambda index: marked.append(trace.MARKERS[index]))
    return marked


@pytest.mark.parametrize("make", [lambda: trace.span("chunk"), lambda: trace.stage("copy"),
                                  lambda: trace.stage("pose", end=True),
                                  lambda: trace.chunk(1, "cuda"), lambda: trace.unmarked()],
                         ids=["span", "stage", "stage_end", "chunk", "unmarked"])
def test_off_is_one_shared_noop(make):
    assert make() is trace.OFF
    with make():
        assert not trace.marking()


@pytest.mark.parametrize("kind", KINDS)
def test_untraced_chunk_launches_nothing_more(sequence, kind, monkeypatch):  # noqa: F811
    """No profiler: no marker is enqueued, even where a card would mark, and
    the kernel counters and captures stay as the chunk leaves them (the CPU
    runs no kernel)."""
    marked = []
    monkeypatch.setattr(trace, "_can_mark", lambda device: True)
    monkeypatch.setattr(trace, "_launch", lambda index: marked.append(index))
    _build.reset_launches()
    _chunk(kind, sequence)
    assert marked == [] and set(_build.LAUNCHES.values()) == {0} and _build.CAPTURES == 0


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_spans_and_frame_stages(sequence, kind):  # noqa: F811
    """One ``dvo.chunk`` holding, in order, the cull, the load, the issue
    loop and the unload; every frame's stage ranges, in step order, inside
    the issue loop and nowhere else; no capture on the CPU."""
    _, events = _profiled(lambda: _chunk(kind, sequence))
    chunks = [ev for ev in events if ev[0] == "dvo.chunk"]
    assert len(chunks) == 1
    inner = _within(events, chunks[0])
    spans = [ev for ev in inner if ev[0] in ("dvo.cull", "dvo.load", "dvo.issue", "dvo.unload",
                                             "dvo.capture")]
    assert [ev[0] for ev in spans] == ["dvo.cull", "dvo.load", "dvo.issue", "dvo.unload"]
    issue = spans[2]
    stages = [ev[0][len("dvo.stage."):] for ev in _within(events, issue)
              if ev[0].startswith("dvo.stage.")]
    assert stages == FRAME_STAGES[kind[:4]] * FRAMES
    others = [ev for ev in events if ev[0].startswith("dvo.stage.")
              and not (issue[1] <= ev[1] and ev[2] <= issue[2])]
    assert [ev[0] for ev in others] == ["dvo.stage.frame_build", "dvo.stage.copy",
                                        "dvo.stage.copy"]


@pytest.mark.parametrize("kind", KINDS)
def test_markers_one_a_region(sequence, kind, launches):  # noqa: F811
    """With markers on, a chunk enqueues the cull's, the load's, every
    frame's same markers and the unload's; no two in a row name one region,
    and every stage region is closed by the next marker."""
    _profiled(lambda: _chunk(kind, sequence))
    frame = FRAME_MARKERS[kind[:4]]
    assert launches == ["frame_build", "end", "copy", "end"] + frame * FRAMES + ["copy", "end"]
    assert all(a != b for a, b in zip(launches, launches[1:]))
    assert launches[-1] == "end"


@pytest.mark.parametrize("mode", ["profiler", "markers"])
@pytest.mark.parametrize("kind", KINDS)
def test_traced_chunk_equals_untraced(sequence, kind, mode, monkeypatch):  # noqa: F811
    """The profiler, and the markers with it, change no output and no state
    bit."""
    if mode == "markers":
        monkeypatch.setattr(trace, "_can_mark", lambda device: True)
        monkeypatch.setattr(trace, "_load", lambda: None)
        monkeypatch.setattr(trace, "_launch", lambda index: None)
    state_a, res_a = _chunk(kind, sequence)
    (state_b, res_b), _ = _profiled(lambda: _chunk(kind, sequence))
    assert same(res_a, res_b) and same(state_a, state_b)


def test_batched_chunk_marks_nothing(sequence, launches):  # noqa: F811
    """B streams: the spans and stages show, no marker is enqueued (the
    profiler's device events carry no stream), and the stack of states is
    the unload's."""
    grays, masks, K, _, resets = sequence
    states = todo.stack_states([_mono_init(sequence), _mono_init(sequence, seed=5)])
    g = torch.stack([grays[1:FRAMES + 1]] * 2)
    m = torch.stack([masks[1:FRAMES + 1]] * 2)
    r = torch.stack([resets[:FRAMES]] * 2)
    _, events = _profiled(lambda: todo.monocular_run_batched(states, g, m, K, CFG, r))
    names = [ev[0] for ev in events if ev[0].startswith("dvo.")
             and not ev[0].startswith("dvo.stage.")]
    assert names == ["dvo.chunk", "dvo.cull", "dvo.load", "dvo.issue", "dvo.unload",
                     "dvo.unload"]
    stages = [ev for ev in events if ev[0].startswith("dvo.stage.")]
    assert len(stages) == 2 * FRAMES * len(FRAME_STAGES["mono"]) + 5
    assert launches == []


def test_runner_spans_in_the_chrome_trace(tmp_path):
    """``run.py --trace`` on the chunked path: the runner's spans around
    every chunk and the program's inside them."""
    seq = str(tmp_path / "seq")
    calib, _ = write_sequence(seq)
    write_yaml(str(tmp_path / "calib.yaml"), {"monocular": calib})
    cli(tcli, ["--data", seq, "--mode", "rgbd", "--calib", str(tmp_path / "calib.yaml"),
               "--max-frames", "5", "--chunk", "2", "--trace", str(tmp_path / "trace"),
               "--out", str(tmp_path / "t.txt"), "--device", "cpu"])
    with open(tmp_path / "trace" / "trace.json") as f:
        names = [ev.get("name") for ev in json.load(f)["traceEvents"]]
    for name in ("dvo.fill", "dvo.upload", "dvo.dispatch", "dvo.drain", "dvo.chunk",
                 "dvo.issue", "dvo.stage.track"):
        assert names.count(name) >= 2, name
