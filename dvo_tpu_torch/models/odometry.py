"""Visual odometry — ``dvo_tpu.models.odometry`` ported, in its two modes:

* ``monocular_*``: track -> pose -> map (promote or depth update) ->
  regularize per frame (reference system.hpp:44-74, mapper.cpp:16-33);
  ``monocular_init_with_depth`` seeds the first keyframe with sensor depth
  (system.hpp:24-32).
* ``rgbd_*``: frame-to-frame tracking against measured depth; every frame
  becomes the next reference and there is no mapper (odometrizeUsingDepth,
  system.hpp:77-93).

Host syncs: none per frame on either path.  The monocular step decides
promotion on the device, as ``dvo_tpu``'s ``lax.cond`` does: it enqueues
both branches (promote: propagate, the new reference, the ring push;
update: the epipolar depth update) and selects their results with
``torch.where`` on the device bool ``need_kf``; the ring's ``head`` and
``count`` and the frame ids are device int32 scalars.  So a step reads
nothing back and can be captured in a CUDA graph.  With ``cfg.ba.enabled``
the step's windowed BA (on a promotion whose window is full) is a
conditional region (``_build.when``): in the captured step a CUDA graph IF
node on the device bool, its window slots gathered on the device from the
ring's ``head``; only an eager step on the card outside a capture reads
that bool back.

A chunk (``monocular_run``, ``rgbd_run``, the batched entry points) runs
through the graphed step driver (``models/graphed``): on the card one CUDA
graph per run and stream, replayed once per frame; B streams replay on B
CUDA streams at once.

Randomness is explicit: the first keyframe's bootstrap noise and the
per-frame depth-filter reset planes come from a ``torch.Generator`` (or are
passed in, which is how the parity tests feed both packages the same
numbers).  A step draws its reset plane on every frame, promotion or not,
as ``dvo_tpu`` splits its key on every frame: the generator advances once
per frame.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from dvo_tpu_torch.config import DVOConfig
from dvo_tpu_torch.models import graphed
from dvo_tpu_torch.models.ba import bundle_adjust, window_from_history, window_slots
from dvo_tpu_torch.models.frame import (
    Frame,
    Scene,
    build_frame,
    build_frame_with_depth,
    build_tracking_frame,
    device_int,
    select_frame,
    with_base_depth,
    with_gradients,
    with_regularized_depth,
)
from dvo_tpu_torch.models.history import (
    KeyframeHistory,
    push,
    refresh_head,
)
from dvo_tpu_torch.models.mapper import (
    DepthUpdateStats,
    depth_update,
    need_new_keyframe,
    propagate,
)
from dvo_tpu_torch.models.tracker import TrackResult, track
from dvo_tpu_torch.ops.cuda import _build, pose
from dvo_tpu_torch.ops.depth_filter import draw_reset_depth
from dvo_tpu_torch.ops.image import cull_image, cull_intrinsic
from dvo_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class VOState:
    """Monocular VO state, resident on one device."""

    history: KeyframeHistory
    ref: Frame                   # current reference keyframe
    generator: torch.Generator   # reset planes when none are passed
    frame_count: torch.Tensor    # () int32 id of the next frame (an int is converted)
    prev_rel: torch.Tensor       # (6,) previous frame's twist vs the ref
    vel: torch.Tensor            # (6,) last frame-to-frame twist

    def __post_init__(self):
        object.__setattr__(self, "frame_count", device_int(self.frame_count, self.ref.xi.device))


@dataclasses.dataclass(frozen=True)
class StepResult:
    T_world: torch.Tensor        # (4, 4) world pose of this frame
    relative_xi: torch.Tensor    # (6,) twist vs the reference keyframe
    is_keyframe: torch.Tensor    # () bool
    tracking: TrackResult
    mapping: DepthUpdateStats
    ba_cost: torch.Tensor        # () final windowed-BA cost; -1 when BA did not run
    # (window, 6): the window's refined poses when this step ran BA (ba_cost
    # >= 0), zeros otherwise; (0, 6) when cfg.ba.enabled is False.  The
    # pose-graph harvester builds its BA edges from these rows: the ring's xi
    # at a chunk's end has been rewritten by later promotions.
    ba_window_xi: torch.Tensor


def _no_ba(device, window: int = 0):
    """``StepResult``'s BA fields of a step on which BA did not run
    (``window``: ``cfg.ba.window`` when BA is enabled, else 0)."""
    return dict(ba_cost=torch.full((), -1.0, dtype=torch.float32, device=device),
                ba_window_xi=torch.zeros((window, 6), dtype=torch.float32, device=device))


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _first_keyframe(frame: Frame, cfg: DVOConfig, generator: torch.Generator) -> VOState:
    """The state whose reference keyframe, and only ring entry, is
    ``frame`` at identity pose (system.hpp:49-54)."""
    device = frame.xi.device
    h, w = frame.base.shape
    history = push(KeyframeHistory.create(cfg.mapper.history_capacity, h, w, device), frame)
    zeros = torch.zeros(6, dtype=torch.float32, device=device)
    return VOState(history=history, ref=frame, generator=generator, frame_count=1,
                   prev_rel=zeros, vel=zeros)


def monocular_init(gray, mask, K, cfg: DVOConfig = DVOConfig.monocular(), *,
                   device="cuda", generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None) -> VOState:
    """First frame becomes the keyframe with identity pose
    (system.hpp:49-54).  Its bootstrap depth noise is ``noise`` (standard
    normal, at the culled size) or is drawn from ``generator`` (default: a
    new one seeded 0 on ``device``), which the state then keeps.

    The state lives on ``device``, and every later step runs there: the
    card by default (without one the call raises; it never runs on the CPU
    unasked), ``device="cpu"`` for the plain versions."""
    gray, mask, K = (torch.as_tensor(x, device=device) for x in (gray, mask, K))
    if noise is not None:
        noise = torch.as_tensor(noise, device=gray.device)
    generator = _generator(gray.device, 0) if generator is None else generator
    frame = build_frame(gray, mask, K, cfg.pyramid.levels, cfg.pyramid.culls, 0,
                        cfg.init, generator=generator, noise=noise)
    return _first_keyframe(frame, cfg, generator)


def monocular_init_with_depth(gray, mask, depth, sigma, K,
                              cfg: DVOConfig = DVOConfig.monocular(), *, device="cuda",
                              generator: Optional[torch.Generator] = None) -> VOState:
    """The monocular pipeline seeded with measured depth (system.hpp:24-32):
    the first keyframe carries ``depth``/``sigma`` instead of the noise
    bootstrap, with the same pyramid as every other frame (as ``dvo_tpu``
    does, not the reference's (4, 1)); later frames run ``monocular_step``.
    ``generator`` (default: a new one seeded 0 on ``device``) draws the
    reset planes that are not passed in.  ``device`` as in
    ``monocular_init``: the card unless ``"cpu"`` is asked for."""
    gray, mask, depth, sigma, K = (torch.as_tensor(x, device=device)
                                   for x in (gray, mask, depth, sigma, K))
    frame = build_frame_with_depth(gray, mask, depth, sigma, K, cfg.pyramid.levels,
                                   cfg.pyramid.culls, 0)
    return _first_keyframe(frame, cfg,
                           _generator(gray.device, 0) if generator is None else generator)


def monocular_step(state: VOState, gray, mask, K, cfg: DVOConfig = DVOConfig.monocular(),
                   reset_depth: Optional[torch.Tensor] = None):
    """One frame: track -> pose -> map -> regularize.  ``reset_depth`` is
    the depth filter's reset plane at the base level; drawn from the
    state's generator when absent.  Returns (state', StepResult).  Traced
    (``utils/trace``), its stages are ``frame_build``, ``pose`` (the warm
    start), ``track``, ``pose``, ``map`` (with the pose table's ``pose``
    inside, and ``ba`` where BA runs) and ``pose``."""
    device = state.ref.xi.device
    gray, mask, K = (torch.as_tensor(x, device=device) for x in (gray, mask, K))
    with trace.stage("frame_build"):
        frame = build_tracking_frame(gray, mask, K, cfg.pyramid.levels, cfg.pyramid.culls,
                                     state.frame_count)

    # --- tracking (system.hpp:57-58) ---
    xi0 = None
    if cfg.tracker.warm_start:
        with trace.stage("pose"):
            xi0 = pose.warm(state.vel, cfg.tracker.warm_start_max_norm, prev_rel=state.prev_rel)
    with trace.stage("track"):
        tr = track(frame, state.ref, cfg.tracker, xi0=xi0)
    with trace.stage("pose"):
        xi, vel, _ = pose.track(state.ref.xi, tr.xi, prev_rel=state.prev_rel)
        frame = dataclasses.replace(frame, relative_xi=tr.xi, xi=xi)
    with trace.stage("map"):
        ref, history, need_kf, stats, ba = _map(state, frame, tr, cfg, reset_depth, device)
    with trace.stage("pose"):
        # A promoted frame is the new reference, whose pose BA may have
        # refined: that pose is the one emitted.
        T_world, prev_rel = pose.emit(need_kf, ref.xi, frame.xi, tr.xi)
        new_state = VOState(
            history=history, ref=ref, generator=state.generator,
            frame_count=state.frame_count + 1, prev_rel=prev_rel, vel=vel,
        )
        result = StepResult(
            T_world=T_world,
            relative_xi=tr.xi,
            is_keyframe=need_kf,
            tracking=tr,
            mapping=stats,
            **ba,
        )
    return new_state, result


def _map(state: VOState, frame: Frame, tr: TrackResult, cfg: DVOConfig, reset_depth, device):
    """The monocular step's mapping (mapper.cpp:16-33): the keyframe
    policy, both branches (promote; the depth update) selected on the
    device, BA where enabled, and the new reference's maps regularised.
    Returns (the new reference, ring, need_kf, the update's statistics,
    the BA fields)."""
    need_kf = need_new_keyframe(tr.xi, frame.frame_id, state.ref.frame_id, cfg.mapper)
    base = state.ref.base
    if reset_depth is None:
        reset_depth = draw_reset_depth(base.shape, cfg.mapper.depth_filter, state.generator,
                                       device)
    # promote: the propagated maps and this frame as the new reference.  The
    # ring keeps its base level as propagated, before the regulariser;
    # refresh_head first gives the outgoing keyframe's slot its current maps,
    # so that the BA window reads them.
    d_p, s_p, age_p = propagate(base.depth, base.sigma, state.ref.age, frame.relative_xi,
                                base.K, cfg.mapper, cfg.init)
    promoted = with_gradients(frame)
    history = push(refresh_head(state.history, state.ref, need_kf),
                   with_base_depth(promoted, d_p, s_p), need_kf)
    # update: the epipolar depth update of the current reference.
    d_u, s_u, age_u, upd = depth_update(
        frame.base, frame.xi, frame.relative_xi, base.depth, base.sigma,
        state.ref.age, state.history, reset_depth, cfg.mapper,
    )
    pick = lambda a, b: torch.where(need_kf, a, b)
    d, s, age = pick(d_p, d_u), pick(s_p, s_u), pick(age_p, age_u)
    ref = select_frame(need_kf, promoted, state.ref)
    stats = DepthUpdateStats(**{f.name: pick(0, getattr(upd, f.name))
                                for f in dataclasses.fields(DepthUpdateStats)})

    ba = _no_ba(device, cfg.ba.window if cfg.ba.enabled else 0)
    if cfg.ba.enabled:
        _windowed_ba(history, ref, d, need_kf, ba, cfg)

    # --- the new maps on every level, the base depth regularised
    # (frame.cpp:39-61, mapper.cpp:30,139-144): one launch on CUDA ---
    ref = with_regularized_depth(ref, d, s, age, cfg.mapper)
    return ref, history, need_kf, stats, ba


def _windowed_ba(history: KeyframeHistory, ref: Frame, d, need_kf, ba: dict, cfg: DVOConfig):
    """Windowed BA on a promotion whose window is full: refine the newest
    ``cfg.ba.window`` keyframe poses and depth maps, write them back into
    the ring's slots, and carry the newest entry (this frame) into the new
    reference: its pose, and its depth ``d``, which goes on to the
    regulariser, sigma and age unchanged; ``ba`` gets the final cost and
    the window's poses.  Every output is written in place, into tensors
    this step made (the window's rows of the ring's pose and depth stacks
    after the push, the reference's pose, ``d``, ``ba``'s): a conditional
    region (``_build.when``), which a captured step skips whole where BA is
    not due.  The window's slots are gathered on the device from the ring's
    ``head``; traced, the region is the ``ba`` stage."""
    m = cfg.ba.window
    due = need_kf & (history.count >= m)
    slots = window_slots(history, m)

    def solve(put):
        with trace.stage("ba"):
            res = bundle_adjust(window_from_history(history, ref.base.K, m, slots), cfg.ba)
            put(history.xi, res.xi, slots)
            put(history.depth, res.depth, slots)
            put(d, res.depth[-1])
            put(ref.xi, res.xi[-1])
            put(ba["ba_cost"], res.costs[-1])
            put(ba["ba_window_xi"], res.xi)

    _build.when(due, solve, "ba")


def _cull_chunk(cfg: DVOConfig, K, *stacks):
    """Decimate a whole (N, H, W) chunk by 2**culls up front.
    Returns (cfg with culls=0, culled K, culled stacks)."""
    culls = cfg.pyramid.culls
    if not culls:
        return cfg, K, stacks
    cfg = dataclasses.replace(cfg, pyramid=dataclasses.replace(cfg.pyramid, culls=0))
    return cfg, cull_intrinsic(K, culls), tuple(cull_image(s, culls) for s in stacks)


def _stack(items):
    """Stack a list of same-shaped dataclasses of tensors field by field: a
    leading axis on every tensor; generators become a tuple, one per item
    (a stack of B states)."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, torch.Generator):
        return tuple(items)
    if isinstance(first, tuple):
        return tuple(_stack(list(z)) for z in zip(*items))
    if first is None:
        return None
    return type(first)(**{f.name: _stack([getattr(i, f.name) for i in items])
                          for f in dataclasses.fields(first)})


def select_streams(tree, b):
    """Stream ``b`` (an int) or the streams ``b`` (a slice) of a stack made
    by ``_stack`` (states or results), as views into it."""
    if isinstance(tree, torch.Tensor):
        return tree[b]
    if isinstance(tree, tuple):
        if tree and isinstance(tree[0], torch.Generator):
            return tree[b]
        return tuple(select_streams(x, b) for x in tree)
    if tree is None:
        return None
    return type(tree)(**{f.name: select_streams(getattr(tree, f.name), b)
                         for f in dataclasses.fields(tree)})


def stack_states(states):
    """B states of one kind and layout as one state with a leading B axis
    on every tensor (a ``VOState``'s ``generator`` becomes the tuple of the B
    generators): the layout of ``dvo_tpu``'s batched states."""
    return _stack(list(states))


def unstack_states(states) -> list:
    """The B per-stream states of a stack (views into it)."""
    return [select_streams(states, b) for b in range(states.frame_count.shape[0])]


def stream_generators(device, streams: int, seed: int = 0) -> list:
    """One generator per stream, derived from one ``seed``: stream b's is
    seeded with the first 64-bit word of
    ``numpy.random.SeedSequence(seed, spawn_key=(b,)).generate_state(1,
    numpy.uint64)``, NumPy's rule for independent child streams, so no two
    streams draw the same planes and stream b's seed does not depend on how
    many streams there are."""
    return [_generator(device, int(np.random.SeedSequence(seed, spawn_key=(b,))
                                   .generate_state(1, np.uint64)[0]))
            for b in range(streams)]


def _spec(sources) -> tuple:
    """What a captured step depends on in its inputs: each input's shape,
    dtype and whether it changes per frame."""
    return tuple((tuple(t.shape[1:] if per_frame else t.shape), t.dtype, per_frame)
                 for t, per_frame in sources)


def _per_stream_K(K, b_count: int) -> list:
    return [K[b] for b in range(b_count)] if K.dim() == 3 else [K] * b_count


def _mono_chunk(owner, states, grays, masks, Ks, cfg: DVOConfig, reset_depths):
    """The graphed monocular chunk of B streams (``graphed.run``): grays
    (B, N, H, W), masks (B, N, H, W) or (B, H, W), reset planes (B, N, h, w)
    or None (drawn from each state's generator), all culled.  Returns (the B
    states', results with leading (B, N) axes, the drivers)."""
    b_count, n = grays.shape[:2]
    sources = [[(grays[b], True), (masks[b], masks.dim() == 4)]
               + ([] if reset_depths is None else [(reset_depths[b], True)])
               for b in range(b_count)]

    def step(state, inputs, K):
        return monocular_step(state, inputs[0], inputs[1], K, cfg,
                              inputs[2] if len(inputs) > 2 else None)

    key = ("mono", cfg, _spec(sources[0]), str(Ks[0].device))
    generators = None if reset_depths is not None else [s.generator for s in states]
    return graphed.run(owner, states, step, key, Ks, sources, n, generators,
                       marked=cfg.ba.enabled and b_count == 1)


def monocular_run(state: VOState, grays, masks, K, cfg: DVOConfig = DVOConfig.monocular(),
                  reset_depths: Optional[torch.Tensor] = None):
    """Run ``monocular_step`` over a chunk of frames (grays: (N, H, W),
    uint8 or float; masks: (N, H, W) or one (H, W) mask for all).
    ``reset_depths`` (N, h, w) at the base level are the per-frame reset
    planes; drawn from the state's generator when absent.  Returns
    (state', StepResult with a leading N axis on every field).

    The chunk runs through the graphed step driver (``models/graphed``): on
    the card one CUDA graph per run, replayed once per frame, with nothing
    read back to the host (with ``cfg.ba.enabled`` too: BA is an IF node of
    the graph); on the CPU the same protocol without capture."""
    device = state.ref.xi.device
    with trace.chunk(1, device):
        return _monocular_run(state, grays, masks, K, cfg, reset_depths)


def _monocular_run(state: VOState, grays, masks, K, cfg: DVOConfig, reset_depths):
    """``monocular_run`` inside its caller's ``dvo.chunk`` span."""
    device = state.ref.xi.device
    grays, masks, K = (torch.as_tensor(x, device=device) for x in (grays, masks, K))
    if reset_depths is not None:
        reset_depths = torch.as_tensor(reset_depths, device=device)
    with trace.span("cull"), trace.stage("frame_build", end=True):
        cfg, K, (grays, masks) = _cull_chunk(cfg, K, grays, masks)
    states, res, drivers = _mono_chunk(state, [state], grays[None], masks[None], [K], cfg,
                                       None if reset_depths is None else reset_depths[None])
    graphed.register(states[0], drivers)
    return states[0], select_streams(res, 0)


# ----------------------------------------------------------------------- RGB-D

@dataclasses.dataclass(frozen=True)
class RGBDState:
    ref: Frame                   # the previous frame, with measured depth
    frame_count: torch.Tensor    # () int32 id of the next frame (an int is converted)
    vel: torch.Tensor            # (6,) last frame-to-frame twist (warm-start prior)

    def __post_init__(self):
        object.__setattr__(self, "frame_count", device_int(self.frame_count, self.ref.xi.device))


def rgbd_init(gray, mask, depth, sigma, K, cfg: DVOConfig = DVOConfig.rgbd(), *,
              device="cuda") -> RGBDState:
    """The first RGB-D frame as the reference, on ``device``: the card by
    default (without one the call raises; it never runs on the CPU unasked),
    ``device="cpu"`` for the plain versions."""
    gray, mask, depth, sigma, K = (torch.as_tensor(x, device=device)
                                   for x in (gray, mask, depth, sigma, K))
    frame = build_frame_with_depth(gray, mask, depth, sigma, K, cfg.pyramid.levels,
                                   cfg.pyramid.culls, 0)
    return RGBDState(ref=frame, frame_count=1,
                     vel=torch.zeros(6, dtype=torch.float32, device=gray.device))


def rgbd_step(state: RGBDState, gray, mask, depth, sigma, K,
              cfg: DVOConfig = DVOConfig.rgbd()):
    """Track against the previous frame, which this frame then replaces
    (system.hpp:77-93).  Returns (state', StepResult with T_world
    composed).  Traced, its stages are ``frame_build``, ``pose`` (the warm
    start), ``track`` and ``pose``."""
    device = state.ref.xi.device
    gray, mask, depth, sigma, K = (torch.as_tensor(x, device=device)
                                   for x in (gray, mask, depth, sigma, K))
    with trace.stage("frame_build"):
        frame = build_frame_with_depth(gray, mask, depth, sigma, K, cfg.pyramid.levels,
                                       cfg.pyramid.culls, state.frame_count)
    xi0 = None
    if cfg.tracker.warm_start:
        with trace.stage("pose"):
            # Frame to frame, the previous twist is the constant-velocity prior.
            xi0 = pose.warm(state.vel, cfg.tracker.warm_start_max_norm)
    with trace.stage("track"):
        tr = track(frame, state.ref, cfg.tracker, xi0=xi0)
    with trace.stage("pose"):
        xi, _, T_world = pose.track(state.ref.xi, tr.xi, world=True)
        frame = dataclasses.replace(frame, relative_xi=tr.xi, xi=xi)
        result = StepResult(
            T_world=T_world,
            relative_xi=tr.xi,
            is_keyframe=torch.ones((), dtype=torch.bool, device=device),
            tracking=tr,
            mapping=DepthUpdateStats.zero(device),
            **_no_ba(device),
        )
        new_state = RGBDState(ref=frame, frame_count=state.frame_count + 1, vel=tr.xi)
    return new_state, result


def _rgbd_chunk(owner, states, grays, masks, depths, sigmas, Ks, cfg: DVOConfig):
    """The graphed RGB-D chunk of B streams: grays, depths, sigmas (B, N,
    H, W), masks (B, N, H, W) or (B, H, W), all culled.  Returns as
    ``_mono_chunk``."""
    b_count, n = grays.shape[:2]
    sources = [[(grays[b], True), (masks[b], masks.dim() == 4), (depths[b], True),
                (sigmas[b], True)] for b in range(b_count)]

    def step(state, inputs, K):
        return rgbd_step(state, *inputs, K, cfg)

    key = ("rgbd", cfg, _spec(sources[0]), str(Ks[0].device))
    return graphed.run(owner, states, step, key, Ks, sources, n)


def rgbd_run(state: RGBDState, grays, masks, depths, sigmas, K,
             cfg: DVOConfig = DVOConfig.rgbd()):
    """Run ``rgbd_step`` over a chunk: grays, depths, sigmas (N, H, W);
    masks (N, H, W) or one (H, W) mask for all.  The 2**culls decimation is
    done once for the chunk, and the chunk runs through the graphed step
    driver as ``monocular_run``'s does.  Returns (state', StepResult with a
    leading N axis on every field)."""
    device = state.ref.xi.device
    with trace.chunk(1, device):
        grays, masks, depths, sigmas, K = (torch.as_tensor(x, device=device)
                                           for x in (grays, masks, depths, sigmas, K))
        with trace.span("cull"), trace.stage("frame_build", end=True):
            cfg, K, (grays, masks, depths, sigmas) = _cull_chunk(cfg, K, grays, masks, depths,
                                                                 sigmas)
        return _rgbd_single(state, grays, masks, depths, sigmas, K, cfg)


def _rgbd_single(state: RGBDState, grays, masks, depths, sigmas, K, cfg: DVOConfig):
    """The graphed RGB-D chunk of one stream, culled."""
    states, res, drivers = _rgbd_chunk(state, [state], grays[None], masks[None], depths[None],
                                       sigmas[None], [K], cfg)
    graphed.register(states[0], drivers)
    return states[0], select_streams(res, 0)


def raw_depth(depths_raw: torch.Tensor, depth_scale: float = 5000.0,
              depth_sigma: float = 0.1):
    """Sensor depth counts -> (depth [m], sigma), as ``dvo_tpu``'s
    ``rgbd_run_raw``: counts times the float32-rounded 1/depth_scale (TUM
    1/5000 m, loader.cpp:145) — so the product rounds exactly as there —
    and sigma = depth_sigma where depth was measured, 1.0 where it is
    missing (transform.cpp:74).  Float depth passes through."""
    if depths_raw.is_floating_point():
        depths = depths_raw
    else:
        depths = depths_raw.to(torch.float32) * float(np.float32(1.0 / depth_scale))
    sigmas = torch.where(depths > 1e-6, depth_sigma, 1.0).to(torch.float32)
    return depths, sigmas


def rgbd_run_raw(state: RGBDState, grays, masks, depths_raw, K,
                 cfg: DVOConfig = DVOConfig.rgbd(), depth_scale: float = 5000.0,
                 depth_sigma: float = 0.1):
    """``rgbd_run`` fed with raw sensor chunks: gray uint8 (or float) and
    depth uint16 counts (or float metres).  The chunk is culled before any
    conversion (integer strides commute with the scale), so only the culled
    pixels are converted, on the device."""
    device = state.ref.xi.device
    with trace.chunk(1, device):
        grays, masks, depths_raw, K = (torch.as_tensor(x, device=device)
                                       for x in (grays, masks, depths_raw, K))
        with trace.span("cull"), trace.stage("frame_build", end=True):
            cfg, K, (grays, masks, depths_raw) = _cull_chunk(cfg, K, grays, masks, depths_raw)
            depths, sigmas = raw_depth(depths_raw, depth_scale, depth_sigma)
        return _rgbd_single(state, grays, masks, depths, sigmas, K, cfg)


# ------------------------------------------------------------------- batched
#
# Multi-stream throughput mode (``dvo_tpu``'s ``monocular_init_batched`` and
# ``monocular_run_batched``, odometry.py:444-467, which vmap the compiled
# chunk over a leading stream axis).  Here each stream has its own graphed
# step driver, replayed on its own CUDA stream, so the B replays of a frame
# run concurrently on the card; the kernels launch once per stream and
# frame.  Streams share nothing: separate rings, generators and static
# state.  A shared (3, 3) K or per-stream (B, 3, 3) intrinsics.


def monocular_init_batched(grays, masks, K, cfg: DVOConfig = DVOConfig.monocular(), *,
                           device="cuda", generators=None, noise=None):
    """Initialise B independent monocular streams: grays, masks (B, H, W);
    K (3, 3) shared or (B, 3, 3).  Stream b draws its bootstrap noise (unless
    ``noise`` (B, h, w) is given) and later its reset planes from
    ``generators[b]``, by default ``stream_generators(device, B)`` (seed 0).
    Returns the stack of the B states (``stack_states``) on ``device``: the
    card unless ``"cpu"`` is asked for."""
    grays, masks, K = (torch.as_tensor(x, device=device) for x in (grays, masks, K))
    b_count = grays.shape[0]
    if generators is None:
        generators = stream_generators(grays.device, b_count)
    return stack_states([
        monocular_init(grays[b], masks[b], k, cfg, device=grays.device,
                       generator=generators[b], noise=None if noise is None else noise[b])
        for b, k in enumerate(_per_stream_K(K, b_count))])


def monocular_run_batched(states: VOState, grays, masks, K,
                          cfg: DVOConfig = DVOConfig.monocular(), reset_depths=None):
    """B-stream chunked driver: ``monocular_run`` of every stream of the
    stack ``states``.  grays (B, N, H, W); masks (B, N, H, W) or (B, H, W);
    K (3, 3) or (B, 3, 3); ``reset_depths`` (B, N, h, w) or None (each
    stream draws from its own generator).  On the card one graphed driver
    per stream, each replayed on its own CUDA stream; on the CPU the
    streams in turn.  Returns (the stack of states', StepResult with
    leading (B, N) axes)."""
    device = states.ref.xi.device
    with trace.chunk(states.frame_count.shape[0], device):
        grays, masks, K = (torch.as_tensor(x, device=device) for x in (grays, masks, K))
        if reset_depths is not None:
            reset_depths = torch.as_tensor(reset_depths, device=device)
        streams = unstack_states(states)
        with trace.span("cull"), trace.stage("frame_build", end=True):
            cfg, K, (grays, masks) = _cull_chunk(cfg, K, grays, masks)
        new, res, drivers = _mono_chunk(states, streams, grays, masks,
                                        _per_stream_K(K, len(streams)), cfg, reset_depths)
        return _stacked(new, drivers), res


def _stacked(states, drivers):
    """The stack of a batched chunk's B states, with the chunk's drivers
    registered: the rest of the chunk's unload."""
    with trace.span("unload"), trace.stage("copy", end=True):
        out = stack_states(states)
    graphed.register(out, drivers)
    return out


def rgbd_run_batched(states: RGBDState, grays, masks, depths, sigmas, K,
                     cfg: DVOConfig = DVOConfig.rgbd()):
    """B-stream RGB-D chunk: ``rgbd_run`` of every stream of the stack
    ``states`` (grays, depths, sigmas (B, N, H, W); masks (B, N, H, W) or
    (B, H, W); K (3, 3) or (B, 3, 3)), as ``monocular_run_batched``.
    Returns (the stack of states', StepResult with leading (B, N) axes)."""
    device = states.ref.xi.device
    with trace.chunk(states.frame_count.shape[0], device):
        grays, masks, depths, sigmas, K = (torch.as_tensor(x, device=device)
                                           for x in (grays, masks, depths, sigmas, K))
        with trace.span("cull"), trace.stage("frame_build", end=True):
            cfg, K, (grays, masks, depths, sigmas) = _cull_chunk(cfg, K, grays, masks, depths,
                                                                 sigmas)
        streams = unstack_states(states)
        new, res, drivers = _rgbd_chunk(states, streams, grays, masks, depths, sigmas,
                                        _per_stream_K(K, len(streams)), cfg)
        return _stacked(new, drivers), res


# ----------------------------------------------------------- state exchange

_RING_PLANES = tuple(f.name for f in dataclasses.fields(KeyframeHistory)
                     if f.name not in ("head", "count"))


def _tensor(x, device, dtype=None):
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _ints(x, device) -> torch.Tensor:
    """An int leaf (0-d, or (B,) in a stack of states) as int32 on ``device``."""
    return torch.tensor(np.asarray(x, np.int32), device=device)


def _scene_from(obj, device) -> Scene:
    return Scene(**{f.name: _tensor(getattr(obj, f.name), device)
                    for f in dataclasses.fields(Scene)})


def frame_from_reference(obj, device) -> Frame:
    """The port's ``Frame`` on ``device`` from a ``dvo_tpu`` Frame with
    numpy leaves (attributes only; no jax import)."""
    return Frame(
        scenes=tuple(_scene_from(s, device) for s in obj.scenes),
        xi=_tensor(obj.xi, device), relative_xi=_tensor(obj.relative_xi, device),
        age=_tensor(obj.age, device, torch.int32), frame_id=_ints(obj.frame_id, device),
    )


def state_from_reference(obj, device, generator=None) -> VOState:
    """The port's ``VOState`` on ``device`` from a ``dvo_tpu`` VOState whose
    leaves are numpy arrays (``jax.tree.map(np.asarray, state)``) or from
    ``state_to_numpy``'s output.  Walks attributes only, so it never
    imports jax.  The PRNG key is not carried: the new state draws from
    ``generator`` (default: a new one seeded 0 on ``device``).  A batched
    state (``monocular_init_batched``'s layout, a leading B axis on every
    leaf) gives a stack of B states; ``generator`` is then a sequence of B
    generators (default: ``stream_generators(device, B)``)."""
    device = torch.device(device)
    h = obj.history
    history = KeyframeHistory(
        **{name: _tensor(getattr(h, name), device) for name in _RING_PLANES},
        head=_ints(h.head, device), count=_ints(h.count, device),
    )
    if np.ndim(obj.frame_count):
        generator = (tuple(stream_generators(device, len(obj.frame_count)))
                     if generator is None else tuple(generator))
    elif generator is None:
        generator = _generator(device, 0)
    return VOState(
        history=history, ref=frame_from_reference(obj.ref, device), generator=generator,
        frame_count=_ints(obj.frame_count, device),
        prev_rel=_tensor(obj.prev_rel, device), vel=_tensor(obj.vel, device),
    )


def rgbd_state_from_reference(obj, device) -> RGBDState:
    """The port's ``RGBDState`` on ``device`` from a ``dvo_tpu`` RGBDState
    with numpy leaves, or from ``rgbd_state_to_numpy``'s output (attributes
    only; no jax import); batched states too."""
    device = torch.device(device)
    return RGBDState(ref=frame_from_reference(obj.ref, device),
                     frame_count=_ints(obj.frame_count, device), vel=_tensor(obj.vel, device))


def _numpy(x):
    return None if x is None else x.detach().cpu().numpy()


def _host_int(x):
    """An int leaf to the host: an np.int32 scalar, or an int32 array in a
    stack of states."""
    return _numpy(x).astype(np.int32)[()]


def _frame_to_numpy(frame: Frame) -> SimpleNamespace:
    return SimpleNamespace(
        scenes=tuple(SimpleNamespace(**{f.name: _numpy(getattr(s, f.name))
                                        for f in dataclasses.fields(s)})
                     for s in frame.scenes),
        xi=_numpy(frame.xi), relative_xi=_numpy(frame.relative_xi), age=_numpy(frame.age),
        frame_id=_host_int(frame.frame_id),
    )


def state_to_numpy(state: VOState) -> SimpleNamespace:
    """The reverse of ``state_from_reference``: the same attribute tree with
    numpy leaves (the generator is not carried); a stack of states keeps
    its leading B axis."""
    h = state.history
    return SimpleNamespace(
        history=SimpleNamespace(
            **{name: _numpy(getattr(h, name)) for name in _RING_PLANES},
            head=_host_int(h.head), count=_host_int(h.count),
        ),
        ref=_frame_to_numpy(state.ref),
        frame_count=_host_int(state.frame_count),
        prev_rel=_numpy(state.prev_rel), vel=_numpy(state.vel),
    )


def rgbd_state_to_numpy(state: RGBDState) -> SimpleNamespace:
    """The reverse of ``rgbd_state_from_reference``."""
    return SimpleNamespace(ref=_frame_to_numpy(state.ref),
                           frame_count=_host_int(state.frame_count), vel=_numpy(state.vel))
