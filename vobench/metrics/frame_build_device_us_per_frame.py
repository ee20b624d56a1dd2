"""Device time a traced frame in the step's ``frame_build`` stage, in us: the
busy time of its regions, each from one of its markers to the next marker,
markers excluded (``vobench.stages``).  The stage is the frame build: the
chunk's cull and, each frame, the pyramid built from the input planes."""

from vobench import stages


def read(ctx):
    return stages.device_us_per_frame(ctx, "frame_build")
