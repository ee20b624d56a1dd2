"""Summed device time of every operation of the traced window per
stream-frame, in us: what the streams ask of the card, overlapped or not."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.frames:
        return None
    return sum(e - s for _, s, e in t.device) / t.frames
