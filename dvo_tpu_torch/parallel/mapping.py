"""Tile-sharded mapping: the epipolar depth update sharded over image rows —
``dvo_tpu.parallel.mapping`` on ``torch.distributed``.

Every rank holds the whole inputs (as ``shard_map`` takes them) and updates
its own row block of the reference keyframe's depth, sigma and age: the
block goes through ``models.mapper.depth_update`` with its row offset — one
launch of ``csrc/epipolar.cu``'s fused entry on the card — against the
whole object frame and keyframe ring (the search lines roam the whole born
image, and at VO resolutions a whole image is far cheaper to hold than a
halo to exchange).  The four counts are summed over the axis by one
``all_reduce``; the maps are gathered by one ``all_gather`` per dtype, so
every rank returns the full (H, W) maps, as ``dvo_tpu``'s global arrays.

Reset noise: ``dvo_tpu`` draws each tile's reset plane from the key folded
with the tile's index.  The port takes the reset plane as an input
(ROADMAP divergence a): one full (H, W) plane, of which each rank uses its
own rows — given the plane ``dvo_tpu``'s tiles draw, row block by row block,
the two agree.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import MapperConfig
from dvo_tpu_torch.models.frame import Scene
from dvo_tpu_torch.models.history import KeyframeHistory
from dvo_tpu_torch.models.mapper import DepthUpdateStats, depth_update
from dvo_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum, tile_rows

STAT_NAMES = ("observed", "accepted", "rejected", "aged_out")


def sharded_depth_update(obj: Scene, obj_xi_w, rel_xi, ref_depth, ref_sigma, ref_age,
                         history: KeyframeHistory, reset_depth, cfg: MapperConfig, mesh,
                         axis: str = "tile"):
    """Row-sharded ``models.mapper.depth_update``: the same outputs, the
    (H, W) maps gathered on every rank and the counts summed over
    ``axis``.  ``reset_depth`` is the full (H, W) reset plane."""
    h, w = ref_depth.shape
    y0, bh, group = tile_rows(mesh, axis, h)
    rows = slice(y0, y0 + bh)
    d, s, a, stats = depth_update(obj, obj_xi_w, rel_xi, ref_depth[rows], ref_sigma[rows],
                                  ref_age[rows], history, reset_depth[rows], cfg,
                                  y_offset=y0, full_shape=(h, w))
    (counts,) = all_reduce_sum([torch.stack([getattr(stats, k) for k in STAT_NAMES])], group)
    depth, sigma, age = all_gather_rows([d, s, a], group)
    return depth, sigma, age, DepthUpdateStats(*counts.unbind())
