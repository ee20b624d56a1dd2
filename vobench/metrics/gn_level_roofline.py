"""The GN level loop's share of its roofline, in %: the least time of the
traced frames' level calls (``vobench.work.gn_level``: inputs read once,
outputs written once, the operations of the steps that ran, against the
H100's 3.35 TB/s and 67 TFLOP/s) over the device time of the kernel that
runs them (``gn_level_kernel``).  None where no such kernel ran."""

from vobench import traced
from vobench import work


def read(ctx):
    if ctx.trace is None:
        return None
    events = ctx.trace.matching(["gn_level_kernel"])
    calls = traced.gn_level_work(ctx)
    if not events or not calls:
        return None
    bound = sum(work.bound_s(b, f) for b, f in calls)
    return 100.0 * bound / (1e-6 * sum(e - s for _, s, e in events))
