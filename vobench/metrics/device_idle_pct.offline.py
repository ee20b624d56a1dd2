"""The share of the window in which no operation ran on the card, in %:
1 - device seconds a frame / wall seconds a frame.  The device seconds are
the union of the kernel, copy and memset intervals of the profiled part
(CUPTI's timestamps), over its frames; the wall is the untraced window's,
over its frames.  The profiled part's own wall is not used: the profiler
stretches it (buffer flushes, slower graph launches), which is not idle
time of the program."""


def read(ctx):
    t, run = ctx.trace, ctx.run
    if t is None or not t.frames or not run.frames:
        return None
    return 100.0 * (1.0 - (t.union_s() / t.frames) / (run.window_s / run.frames))
