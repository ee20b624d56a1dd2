"""Seconds of the set-up's first window-sized call (which captures the
step's CUDA graph) above a steady call of the same size."""


def read(ctx):
    return ctx.run.capture_s
