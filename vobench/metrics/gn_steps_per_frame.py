"""GN steps a frame, summed over the pyramid levels: the tracker's
``iterations`` from the window's own results, over every frame."""


def read(ctx):
    it = ctx.run.host.get("iterations") if ctx.run.host else None
    if it is None or it.size == 0:
        return None
    return float(it.reshape(-1, it.shape[-1]).sum(axis=-1).mean())
