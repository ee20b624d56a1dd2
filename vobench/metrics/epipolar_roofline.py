"""The epipolar depth update's share of its roofline, in %: the least time
of one update of the base level with a full ring (``vobench.work.
epipolar_fused``: the raw maps, every ring slot's gray, gradients and
mask, the pose table; operations counted without the marched samples,
which the outputs do not tell, so the share is a lower bound) for each
traced call, over the device time of ``epipolar_kernel``."""

from vobench import traced
from vobench import work


def read(ctx):
    if ctx.trace is None:
        return None
    events = ctx.trace.matching(["epipolar_kernel"])
    if not events:
        return None
    cap = ctx.config["dvo"]["mapper"]["history_capacity"]
    one = work.bound_s(*work.epipolar_fused(traced.base_shape(ctx.config), cap, 0, cap))
    return 100.0 * one * len(events) / (1e-6 * sum(e - s for _, s, e in events))
