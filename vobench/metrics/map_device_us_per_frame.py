"""Device time a traced frame in the step's ``map`` stage, in us: the busy
time of its regions, each from one of its markers to the next marker,
markers excluded (``vobench.stages``).  The stage is mapping: the keyframe
policy, propagation, the ring push, the depth update less its pose table,
the selects and the regulariser."""

from vobench import stages


def read(ctx):
    return stages.device_us_per_frame(ctx, "map")
