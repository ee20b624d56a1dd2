"""Tile-sharded photometric GN tracking — ``dvo_tpu.parallel.tracking`` on
``torch.distributed``.

The dense per-pixel linearisation is parallel over pixels, so image rows
shard over the ``tile`` mesh axis.  Every rank holds the whole frames (as
``shard_map`` takes them) and linearises its own row block: the object
planes and the reference depth and sigma of rows [r * bh, (r + 1) * bh),
against the whole reference gray, mask and gradients (warped points cross
block boundaries, and at VO resolutions a whole image is a few hundred KB).
The block goes through ``ops.cuda.gn.gn_terms`` with its row offset — one
``csrc/gn.cu`` launch on the card — and the 44 sums (H 36, g 6, the
residual sum and the count) are summed over the axis by one ``all_reduce``
per GN step.  The solve, the pose update and the convergence test then run
replicated on every rank, on the device: nothing is read back to the host
inside the loop on an NCCL group.  On a gloo group the 44 sums travel
through the host.

A sharded level cannot use the one-launch level kernel (``gn_level.cu``):
every step needs the reduction over ranks.  It is the fixed-length masked
loop of ``dvo_tpu``'s scan, ``max_iterations`` steps with a ``done`` mask.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import TrackerConfig
from dvo_tpu_torch.models.frame import Frame, Scene
from dvo_tpu_torch.models.tracker import level_planes, track_level
from dvo_tpu_torch.ops.cuda import gn
from dvo_tpu_torch.ops.cuda.gn_level import gn_iteration
from dvo_tpu_torch.parallel.mesh import all_reduce_sum, axis_group, tile_rows

# The count travels as a float32 beside the 43 float sums: exact for any
# image of fewer than 2**24 pixels.
MAX_PIXELS = 1 << 24


def _sharded_terms(mesh, axis):
    """A terms function with ``gn.gn_terms``' arguments (the nine whole
    planes, K, T_inv, level, cfg) that linearises this rank's row block and
    sums the result over ``axis``."""

    def terms(obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray, ref_mask, ref_gx, ref_gy,
              ref_gmask, K, T_inv, level_index, cfg):
        h, w = ref_depth.shape
        if h * w >= MAX_PIXELS:
            raise ValueError(f"a {h}x{w} image: the count is summed in float32")
        y0, bh, group = tile_rows(mesh, axis, h)
        rows = slice(y0, y0 + bh)
        Hm, g, rsum, count = gn.gn_terms(
            obj_gray[rows], obj_mask[rows], ref_depth[rows], ref_sigma[rows],
            ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask, K, T_inv, level_index, cfg,
            y_offset=y0, full_shape=(h, w))
        (sums,) = all_reduce_sum(
            [torch.cat([Hm.reshape(36), g, rsum[None], count[None].to(torch.float32)])], group)
        return sums[:36].reshape(6, 6), sums[36:42], sums[42], sums[43].to(torch.int32)

    return terms


def sharded_gn_normal_equations(obj: Scene, ref: Scene, xi, level_index: int,
                                cfg: TrackerConfig, mesh, axis: str = "tile"):
    """One linearisation with rows sharded over ``axis``; returns the same
    (H, g, residual_sum, count) as the single-device path, summed over the
    axis, on every rank."""
    return _sharded_terms(mesh, axis)(*level_planes(obj, ref), ref.K, lie.se3_exp(-xi),
                                      level_index, cfg)


def sharded_track_level(obj: Scene, ref: Scene, xi0, level_index: int, cfg: TrackerConfig,
                        mesh, axis: str = "tile"):
    """``max_iterations`` GN steps at one level, each linearisation sharded
    (``sharded_gn_normal_equations``), a ``done`` mask freezing xi after
    convergence, as ``dvo_tpu``'s scan.  Returns (xi, (mean residuals,
    update norms, counts)), one entry per step."""
    terms = _sharded_terms(mesh, axis)
    planes = level_planes(obj, ref)
    xi = xi0
    done = torch.zeros((), dtype=torch.bool, device=xi0.device)
    res, upd, cnt = [], [], []
    for _ in range(cfg.max_iterations):
        new_xi, mean_res, u, count, converged = gn_iteration(planes, ref.K, xi, level_index,
                                                            cfg, terms)
        xi = torch.where(done, xi, new_xi)
        done = done | converged
        res.append(mean_res)
        upd.append(u)
        cnt.append(count)
    return xi, (torch.stack(res), torch.stack(upd), torch.stack(cnt))


def sharded_track(obj_frame: Frame, ref_frame: Frame, cfg: TrackerConfig, mesh,
                  axis: str = "tile"):
    """Coarse-to-fine track with every level's linearisation tile-sharded.
    A level is sharded when the axis divides its height and leaves at least
    4 rows a tile; the others (the coarsest: a few hundred pixels) run
    replicated through ``models.tracker.track_level``, the level kernel."""
    _, n_tiles, _ = axis_group(mesh, axis)
    xi = torch.zeros(6, dtype=torch.float32, device=ref_frame.xi.device)
    for level in range(len(ref_frame.scenes)):
        obj, ref = obj_frame.scenes[level], ref_frame.scenes[level]
        if ref.shape[0] % n_tiles == 0 and ref.shape[0] >= 4 * n_tiles:
            xi, _ = sharded_track_level(obj, ref, xi, level, cfg, mesh, axis)
        else:
            xi, _ = track_level(obj, ref, xi, level, cfg)
    return xi
