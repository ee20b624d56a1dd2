"""Windowed BA's share of its roofline, in %: the least time of the traced
solves (``vobench.work_ba.ba_solve`` at the configuration's window, base
size and iterations, against the H100's peaks in ``vobench.work``) over the
device busy time of the step's ``ba`` regions (``vobench.stages``).  None
where the trace holds no ``ba`` region."""

from vobench import stages, traced, work, work_ba


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    solves = [r for r in stages.regions(t) if r[0] == "ba"]
    busy_us = sum(r[4] for r in solves)
    if not solves or busy_us <= 0:
        return None
    c = ctx.config["dvo"]["ba"]
    one = work.bound_s(*work_ba.ba_solve(c["window"], traced.base_shape(ctx.config),
                                         c["iterations"]))
    return 100.0 * one * len(solves) / (1e-6 * busy_us)
