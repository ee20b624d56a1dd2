"""Tile-sharded photometric GN tracking — ``dvo_tpu.parallel.tracking`` on
``torch.distributed``.

The dense per-pixel linearisation is parallel over pixels, so image rows
shard over the ``tile`` mesh axis.  Every rank holds the whole frames (as
``shard_map`` takes them) and linearises its own row block: the object
planes and the reference depth and sigma of rows [r * bh, (r + 1) * bh),
against the whole reference gray, mask and gradients (warped points cross
block boundaries, and at VO resolutions a whole image is a few hundred KB).

A sharded level is ``dvo_tpu``'s scan: ``max_iterations`` steps, a ``done``
flag freezing xi after convergence, every step's statistics recorded.  It
cannot use the one-launch level kernel (``gn_level.cu``): every step needs
the reduction over ranks.  A step is three ops and no host read: one
``csrc/gn.cu`` launch that linearises the rank's block and reduces its 29
sums (H's lower triangle, g, the residual sum, the count) on the card, one
in-place ``all_reduce`` of those 29 floats, and one launch of ``gn.cu``'s
step kernel, which solves, updates the pose and writes the state the next
linearisation reads (``gn.terms_launcher``, ``gn_level.step_launcher``).
On a gloo group the 29 sums travel through the host.  On CPU tensors the
two launchers run their plain versions (``gn_terms_plain`` packed,
``gn_level.step_plain``) in the same loop.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import TrackerConfig
from dvo_tpu_torch.models.frame import Frame, Scene
from dvo_tpu_torch.models.tracker import level_planes, track_level
from dvo_tpu_torch.ops.cuda import gn
from dvo_tpu_torch.ops.cuda.gn_level import SEED, STATE, step_launcher
from dvo_tpu_torch.parallel.mesh import all_reduce_, all_reduce_sum, axis_group, tile_rows

def _sharded_terms(mesh, axis):
    """A terms function with ``gn.gn_terms``' arguments (the nine whole
    planes, K, T_inv, level, cfg) that linearises this rank's row block and
    sums the result over ``axis``."""

    def terms(obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray, ref_mask, ref_gx, ref_gy,
              ref_gmask, K, T_inv, level_index, cfg):
        h, w = ref_depth.shape
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
    over ``axis``, a ``done`` flag freezing xi after convergence, as
    ``dvo_tpu``'s scan.  Returns (xi, (mean residuals, update norms,
    counts)), one entry per step, recorded after convergence too.  The
    buffers are allocated once; the step kernel seeds the state from xi0;
    then a step is the linearisation of the rank's block, the 29 sums
    all-reduced in place, the step kernel.  Nothing is read back to the
    host."""
    planes = level_planes(obj, ref)
    h, w = planes[2].shape
    y0, bh, group = tile_rows(mesh, axis, h)
    rows = slice(y0, y0 + bh)
    terms = gn.terms_launcher((*(p[rows] for p in planes[:4]), *planes[4:]), ref.K,
                              level_index, cfg, y_offset=y0, full_shape=(h, w))
    dev, f32, n = xi0.device, torch.float32, cfg.max_iterations
    sums = torch.empty(gn.N_SUMS, dtype=f32, device=dev)
    state = torch.empty(STATE, dtype=f32, device=dev)
    stats = torch.empty(2 * n, dtype=f32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    step = step_launcher(sums, xi0, state, stats[:n], stats[n:], counts, cfg)
    step(SEED)
    for it in range(n):
        terms(state, sums)
        all_reduce_(sums, group)
        step(it)
    return state[12:18], (stats[:n], stats[n:], counts)


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
