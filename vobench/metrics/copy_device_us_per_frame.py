"""Device time a traced frame in the step's ``copy`` stage, in us: the busy
time of its regions, each from one of its markers to the next marker,
markers excluded (``vobench.stages``).  The stage is the graphed driver's
data movement: each frame's input copy, the state's copy-back, the results'
copy, the chunk's load and unload."""

from vobench import stages


def read(ctx):
    return stages.device_us_per_frame(ctx, "copy")
