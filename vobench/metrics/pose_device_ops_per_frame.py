"""Device operations a traced frame in the step's ``pose`` stage, markers
excluded (``vobench.stages``): the pose algebra outside the kernels, which
runs as many small elementwise kernels."""

from vobench import stages


def read(ctx):
    return stages.device_ops_per_frame(ctx, "pose")
