"""Frames whose results reached the host over the window's wall, the last
chunk's drain included, every stream counted."""


def read(ctx):
    return ctx.run.frames / ctx.run.window_s
