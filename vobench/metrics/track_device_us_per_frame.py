"""Device time a traced frame in the step's ``track`` stage, in us: the busy
time of its regions, each from one of its markers to the next marker,
markers excluded (``vobench.stages``).  The stage is tracking: every GN
level loop of the tracker (``gn_level``) and what it stacks."""

from vobench import stages


def read(ctx):
    return stages.device_us_per_frame(ctx, "track")
