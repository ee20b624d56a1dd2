"""Host time a traced frame in the graphed driver's issue loop (the
program's ``dvo.issue`` spans: each frame's input copy, replay and result
copy enqueued), in us, over the traced frames (``vobench.stages``)."""

from vobench import stages


def read(ctx):
    return stages.host_us_per_frame(ctx, "issue")
