"""Windowed BA solves a traced frame: the step's ``ba`` regions on the
card's timeline (``vobench.stages``; the region's marker runs only where a
solve runs), over the traced frames.  None where the trace holds no ``ba``
region."""

from vobench import stages


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    solves = sum(1 for r in stages.regions(t) if r[0] == "ba")
    return solves / t.frames if solves else None
