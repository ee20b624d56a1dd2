"""The whole step's share of the card's float32 peak, in %: the operations
of a traced frame (``vobench.work``: the GN level loops as they ran, the
frame build, and on the monocular path the depth update without its
marched samples and the regulariser), averaged over the profiled part,
times the untraced window's frames a second, over 67 TFLOP/s.  It counts
the same work whatever kernels compute it."""

from vobench import traced
from vobench import work


def read(ctx):
    t, run = ctx.trace, ctx.run
    calls = traced.gn_level_work(ctx) if t is not None else []
    if not calls or not t.frames or not run.frames:
        return None
    levels = ctx.config["dvo"]["pyramid"]["levels"]
    base = traced.base_shape(ctx.config)
    n = base[0] * base[1]
    per_frame = work.framebuild(base, levels, 1 if ctx.config["mode"] == "mono" else 3)[1]
    if ctx.config["mode"] == "mono":
        per_frame += work.EPI_FLOPS_PER_PIXEL * n + work.regularize_cull(base, levels)[1]
    flops = sum(f for _, f in calls) / t.frames + per_frame
    return 100.0 * flops * (run.frames / run.window_s) / work.PEAK_FLOPS_F32
