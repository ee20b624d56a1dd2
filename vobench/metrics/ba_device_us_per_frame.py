"""Device time a traced frame in the step's ``ba`` stage, in us: the busy
time of its regions (``vobench.stages``), each a windowed BA solve and its
write-back into the ring, over all traced frames, solved or not.  None
where the trace holds no ``ba`` region."""

from vobench import stages


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    solves = [r for r in stages.regions(t) if r[0] == "ba"]
    return sum(r[4] for r in solves) / t.frames if solves else None
