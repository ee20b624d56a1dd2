"""Device operations (kernels, copies, memsets) of the traced window per
frame: the step and its graphed driver."""


def read(ctx):
    t = ctx.trace
    return None if t is None or not t.frames else len(t.device) / t.frames
