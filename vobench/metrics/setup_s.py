"""Seconds from the process's start to the first timed frame: loading,
rendering the rigs, the first run's nvcc build, warming and capturing."""


def read(ctx):
    return ctx.run.setup_s
