"""Device time a traced frame in the step's ``pose`` stage, in us: the busy
time of its regions, each from one of its markers to the next marker,
markers excluded (``vobench.stages``).  The stage is the pose algebra
outside the kernels: the warm start, the new pose and velocity, the depth
update's pose table, the emitted pose."""

from vobench import stages


def read(ctx):
    return stages.device_us_per_frame(ctx, "pose")
