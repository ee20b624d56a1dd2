"""The program's own marks in a traced window (``profiling.Trace``): its
stage markers on the card's timeline and its host spans.

While a profiler records, the program enqueues an empty kernel
``dvo_stage_<stage>`` where each stage of its step begins, and
``dvo_stage_end`` where the card's time stops belonging to a stage; it
opens host ranges ``dvo.<span>`` at the boundaries of a chunk.  Here the
device events, sorted by start, are cut at the markers: a region runs from
one marker's start to the next marker's start (the last to the end of the
last event), and holds the events that start in it.  A stage's time is the
device's busy time in its regions: the union of its operations' intervals,
markers excluded, the same union that ``device_idle_pct.*`` takes of the
whole window, so that the stages and the ``end`` regions add up to it
less the markers.  It leaves out the gaps between the operations: under
the profiler a region's wall holds the host's issue latency (an eager
copy waits for its launch) and launch gaps that the profiler stretches.

This reads the trace alone and imports nothing of the program.  Where the
trace holds no marker (a program without them, or a fleet, whose streams
the profiler's events cannot tell apart), every stage reader returns None;
where it holds no span of a name, so does the span's reader.
"""

from __future__ import annotations

MARKER = "dvo_stage_"


def regions(trace) -> list:
    """[(stage, start us, end us, operations, busy us)] in time order; []
    where no marker ran."""
    events = sorted(trace.device, key=lambda ev: ev[1])
    out, last = [], max((end for _, _, end in events), default=None)
    bounds = [start for name, start, _ in events if name.startswith(MARKER)] + [last]
    k = -1
    reach = None                     # the end of the busy time counted so far
    for name, start, end in events:
        if name.startswith(MARKER):
            k += 1
            out.append([name[len(MARKER):], start, bounds[k + 1], 0, 0.0])
            reach = end
            continue
        if k < 0:
            continue
        region = out[-1]
        region[3] += 1
        a, b = max(start, reach), min(end, region[2])
        if b > a:
            region[4] += b - a
            reach = b
    return [tuple(r) for r in out]


def _marked(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    marked = regions(t)
    return marked or None


def device_us_per_frame(ctx, stage: str):
    """Device busy time of the stage's regions a traced frame, in us."""
    marked = _marked(ctx)
    if marked is None:
        return None
    return sum(r[4] for r in marked if r[0] == stage) / ctx.trace.frames


def device_ops_per_frame(ctx, stage: str):
    """Device operations of the stage's regions a traced frame."""
    marked = _marked(ctx)
    if marked is None:
        return None
    return sum(r[3] for r in marked if r[0] == stage) / ctx.trace.frames


def host_us_per_frame(ctx, span: str):
    """Summed duration of the host spans ``dvo.<span>`` a traced frame, in us."""
    t = ctx.trace
    if t is None or not t.frames:
        return None
    spans = [end - start for name, start, end in t.host if name == f"dvo.{span}"]
    return sum(spans) / t.frames if spans else None
