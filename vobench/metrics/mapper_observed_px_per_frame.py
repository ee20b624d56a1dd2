"""Pixels a frame with a gated-valid epipolar observation (the mapper's
``observed`` count, 0 on a promotion), over every frame of the window."""


def read(ctx):
    obs = ctx.run.host.get("observed") if ctx.run.host else None
    if obs is None or obs.size == 0:
        return None
    return float(obs.mean())
