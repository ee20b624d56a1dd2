"""What the roofline and peak readers share: a configuration's pyramid
sizes and the outputs of the traced frames."""

import numpy as np

from vobench import work


def base_shape(config):
    culls = config["dvo"]["pyramid"]["culls"]
    h, w = config["input"]["height"], config["input"]["width"]
    return -(-h // 2 ** culls), -(-w // 2 ** culls)


def level_sizes(config):
    return work.level_sizes(base_shape(config), config["dvo"]["pyramid"]["levels"])


def frames_of(ctx, key):
    """The host outputs ``key`` of the traced frames, streams flattened:
    (frames, ...)."""
    host, t = ctx.run.host, ctx.trace
    if not host or key not in host or t is None:
        return None
    x = host[key]
    if ctx.traffic["streams"] > 1:
        x = np.moveaxis(x, 0, 1)          # (frames, streams, ...)
    per_stream = t.frames // ctx.traffic["streams"]
    x = x[t.first:t.first + per_stream]
    return x.reshape((-1,) + x.shape[2 if ctx.traffic["streams"] > 1 else 1:])


def gn_level_work(ctx):
    """[(bytes, flops)] of every traced level call."""
    vc, it = frames_of(ctx, "valid_counts"), frames_of(ctx, "iterations")
    if vc is None:
        return []
    sizes = level_sizes(ctx.config)
    max_it = ctx.config["dvo"]["tracker"]["max_iterations"]
    return [work.gn_level(sizes[lv], vc[f, lv, :it[f, lv]], max_it)
            for f in range(vc.shape[0]) for lv in range(len(sizes))]
