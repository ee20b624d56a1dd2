#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dvo_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one line each (or a few):
  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — compile ``dvo_tpu_torch/csrc/*.cu`` with nvcc (first use).
  3. kernels  — each kernel against its plain PyTorch version on the card,
                on inputs from a real run at the paths' shapes: GN at 30x40,
                60x80 and 120x160 (mono) and at 27x32, 53x64, 106x128 and
                212x256 (RGB-D), epipolar with the full 8-slot ring and
                regularize at 120x160, and the frame build (held equal with
                ``torch.equal``) for the RGB-D build and one plane at
                212x256 x 4 levels and, at 120x160 x 3, the mono tracking
                build, a build with depth, the depth/sigma pair and one
                plane.  All of it but the RGB-D part again at Kinect mono's
                shapes (106x128 x 3), on a ``monocular_init_with_depth``
                state of the RGB-D frames run until its ring is full.  Times
                from CUDA events.
  4. main     — ``monocular_init`` + ``monocular_run`` with
                ``DVOConfig.monocular()`` on 48 synthetic 640x480 uint8
                frames (chunks of 24); every kernel must have launched.
  5. cpu      — the first 8 frames again on the CPU (plain versions, same
                bootstrap noise and reset planes); poses and keyframe flags
                must agree with the CUDA run.
  6. rgbd     — ``rgbd_init`` + ``rgbd_run_raw`` with ``DVOConfig.rgbd()``
                on 64 synthetic 512x424 frames (uint8 gray, uint16 depth
                counts with holes) in one chunk; every twist must recover the
                step; GN and the frame build must have launched; the first 8
                frames again on the CPU must agree.
  7. monodepth — ``monocular_init_with_depth`` + ``monocular_run`` on 12
                640x480 frames; all four kernels must have launched.
  8. syncs    — host syncs per frame under ``set_sync_debug_mode``: none
                on the RGB-D path, one (the keyframe branch) on the mono one.
  9. cli      — ``python -m dvo_tpu_torch.run`` (its ``main``, in this
                process) on PNG sequences written from the frames above with
                a zlib writer, and calibration YAMLs: RGB-D (the 64 frames of
                phase 6, ``--chunk 24``), mono (the 48 frames of phase 4,
                ``--chunk 24 --checkpoint``) and Kinect in both modes (8
                pairs of 1920x1080 color and 512x424 depth, ``--chunk 3``).
                Prints the decode route and, per path, ms/frame with the wall
                split into decode and dispatch/drain.  Requires finite poses
                and the launches of each path's kernels; the RGB-D poses
                within 1e-5 of ``rgbd_init`` + ``rgbd_run_raw`` on the same
                frames; the reloaded checkpoint's next step equal to the live
                state's; no host sync inside an RGB-D chunk's dispatch; the
                Kinect RGB-D poses within 5e-3 of the RGB-D CLI's; each Kinect
                mode's first 5 frames (one chunk and a tail) within 1e-5 of
                the same command with ``--device cpu``, both fed the same
                reset planes.
Each path's launch counts are set to 0 just before it runs and read just
after.  Then a JSON line of per-kernel results and, last, the device JSON
line.  Any failure raises (exit code != 0) before the last line is printed.
It imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import zlib

import numpy as np
import torch

SEED = 0
N_FRAMES = 48           # frames after the first (keyframe) one
CHUNK = 24
CPU_FRAMES = 8
H, W = 480, 640
STEP_XI = (0.014, 0.004, 0.006, 0.001, -0.002, 0.001)  # per-frame motion
# RGB-D: Kinect v2 depth resolution, culled once by DVOConfig.rgbd() to a
# 256x212 base with 4 levels.
RGBD_FRAMES = 64        # frames after the first one, in one chunk
RH, RW = 424, 512
RGBD_STEP = (0.004, -0.002, 0.002, 0.001, -0.0015, 0.0005)
DEPTH_SCALE = 5000.0    # TUM counts per metre
HOLES = 0.03            # share of pixels without a depth measurement
NOISE = 0.06            # gray sensor noise (std): GN then iterates as on real frames
MONO_DEPTH_FRAMES = 12
SYNC_FRAMES = 4
CLI_CHUNK = 24          # the CLI's default --chunk
KINECT_FRAMES = 8       # Kinect pairs: 1920x1080 color, 512x424 depth
KINECT_CHUNK = 3        # 7 steps: two chunks and a one-frame tail
KINECT_CPU_FRAMES = 5   # the Kinect CLI on the CPU: one chunk and a one-frame tail
KINECT_WARM = 8         # frames per run while the Kinect-mono ring fills

# Tolerances of a kernel against its plain version on the card.  Both are
# built to round the same way per pixel (no FMA contraction, IEEE division
# and sqrt); what differs is summation order (GN's block reduction vs
# torch.einsum) and the plain version's batched 3x3 matmuls, which can move
# a warped coordinate by an ulp and so flip a pixel sitting exactly on a
# strict gate.
GN_REL_TOL = 1e-4        # max |dH|, |dg|, |drsum| over the plain value's max
GN_COUNT_TOL = 0.001     # share of pixels whose gate may flip
MAP_VALUE_TOL = 1e-5     # per-pixel |d| <= tol * (1 + |d_plain|) ...
MAP_SHARE = 0.999        # ... on at least this share of pixels
STATS_TOL = 0.01         # epipolar counts within 1% (or 2 pixels)
# Measured on an H100 (700 W): GN 3.6e-6 relative with equal counts,
# epipolar and regularize bit-identical to their plain versions.
# CUDA run vs CPU run of the first frames: the GN kernel's summation order
# differs from the CPU's einsum, so poses agree to float noise carried
# through 8 frames of tracking (measured 1.4e-7 on the H100), not bit for bit.
POSE_TOL = 1e-5
# Every RGB-D frame-to-frame twist against the rendered step (|d xi|).  The
# frames are inverse warps of frame 0 with depth0 plus gray noise, tracked
# against the approximate per-frame depth depth0 - k * tz
# (tests/test_odometry.py) with DVOConfig.rgbd()'s 1.5e-3 update-norm gate,
# so the bound comes from a measured error, not from float noise: the first
# 20 frames on the CPU missed the step by at most 2.0e-3 (median 1.0e-3).
STEP_TOL = 5e-3
# The Kinect RGB-D CLI against the plain RGB-D CLI on the same frames: the
# registration lands on the depth view's own pixels, so what differs is the
# depth holes, which the Kinect path masks out of the gray (measured 8.1e-4
# on the H100).  Held to the rendered-step bound.
KINECT_GAP_TOL = STEP_TOL


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def texture(rng, h, w, terms=8, lo=0.04, hi=0.2):
    """A sum of random sinusoids, normalised to [0, 1]."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(terms):
        fx, fy = rng.uniform(lo, hi, 2)
        ph = rng.uniform(0, 6.28, 2)
        img += rng.uniform(0.5, 1.0) * np.sin(fx * xs + ph[0]) * np.sin(fy * ys + ph[1])
    return (img - img.min()) / (img.max() - img.min())


def smooth_field(rng, h, w):
    """A slowly varying field of about [-4, 4] (a sum of four products of
    low-frequency sines)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = np.zeros((h, w), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.002, 0.01, 2)
        smooth += np.sin(fx * xs + rng.uniform(0, 6.28)) * np.sin(fy * ys + rng.uniform(0, 6.28))
    return smooth


def render(base, depth, K, step, n: int):
    """Frame 0 and ``n`` frames under constant motion ``step``, each the
    port's inverse warp of frame 0 with ``depth``; float gray in [0, 1]."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.ops.warp import warp_image

    dev = base.device
    ones = torch.ones(base.shape, dtype=torch.bool, device=dev)
    step = torch.tensor(step, dtype=torch.float32, device=dev)
    xi = torch.zeros(6, dtype=torch.float32, device=dev)
    grays, masks = [base], [ones]
    for _ in range(n):
        xi = lie.compose(xi, step)
        img, mask = warp_image(xi, base, ones, depth, K)
        grays.append(img)
        masks.append(mask)
    return torch.stack(grays), torch.stack(masks)


def to_uint8(grays):
    return torch.clamp(torch.round(grays * 255.0), 0, 255).to(torch.uint8)


def render_sequence(device):
    """N_FRAMES + 1 frames of a static textured scene under constant small
    motion, rendered with the port's inverse warp; uint8, 640x480.  Also
    returns frame 0's depth."""
    rng = np.random.default_rng(SEED)
    base = texture(rng, H, W)
    depth = (1.5 + 0.1 * smooth_field(rng, H, W)).astype(np.float32)
    K = torch.tensor([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], device=device)
    depth_t = torch.from_numpy(depth).to(device)
    grays, masks = render(torch.from_numpy(base).to(device), depth_t, K, STEP_XI, N_FRAMES)
    return to_uint8(grays), masks, K, depth_t


def render_rgbd(device):
    """RGBD_FRAMES + 1 frames at 512x424, shipped as a sensor would: uint8
    gray with NOISE and uint16 depth counts (DEPTH_SCALE per metre) with
    HOLES of the pixels at 0, all on the host.  Frame k's depth is
    depth0 - k * tz."""
    rng = np.random.default_rng(SEED + 1)
    base = texture(rng, RH, RW, 12, 0.1, 0.5)
    depth0 = (1.8 + 0.1 * smooth_field(rng, RH, RW)).astype(np.float32)
    K = torch.tensor([[365.0, 0, 256.0], [0, 365.0, 212.0], [0, 0, 1]])
    grays, masks = render(torch.from_numpy(base).to(device), torch.from_numpy(depth0).to(device),
                          K.to(device), RGBD_STEP, RGBD_FRAMES)
    noise = rng.standard_normal(grays.shape, dtype=np.float32) * np.float32(NOISE)
    grays = grays + torch.from_numpy(noise).to(device)
    k = np.arange(RGBD_FRAMES + 1, dtype=np.float32)[:, None, None]
    depths = depth0[None] - k * np.float32(RGBD_STEP[2])
    counts = np.round(depths * DEPTH_SCALE).astype(np.uint16)
    counts[rng.random(counts.shape) < HOLES] = 0
    return to_uint8(grays).cpu(), masks.cpu(), torch.from_numpy(counts), K


def _flat(out):
    """The tensors of a frame-build output (lists, tuples, per-level dicts)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _flat(v)]
    return []


def check_framebuild(label, wrapper, plain, *args):
    """The kernel's planes against the plain version's, with torch.equal.
    Returns (max abs error, kernel ms, plain ms)."""
    got, want = _flat(wrapper(*args)), _flat(plain(*args))
    torch.cuda.synchronize()
    if len(got) != len(want) or not got:
        raise AssertionError(f"framebuild {label}: {len(got)} planes vs {len(want)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"framebuild {label}: plane {i} differs from the plain version")
        if a.is_floating_point():
            err = max(err, (a - b).abs().max().item())
    ms = timed(lambda: wrapper(*args))
    plain_ms = timed(lambda: plain(*args))
    phase("kernels", f"framebuild {label}: {len(got)} planes equal, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def check_gn(obj_scenes, ref_scenes, T_inv, cfg, gn_times, tag=""):
    """GN kernel vs plain at every level; fills gn_times[tag + shape] and
    returns (max abs error, max relative error)."""
    from dvo_tpu_torch.ops.cuda import gn

    gn_err, gn_rel = 0.0, 0.0
    for level, (obj, ref) in enumerate(zip(obj_scenes, ref_scenes)):
        args = (obj.gray, obj.mask, ref.depth, ref.sigma, ref.gray, ref.mask,
                ref.gx, ref.gy, ref.gmask, ref.K, T_inv, level, cfg)
        got = gn.gn_terms(*args)
        want = gn.gn_terms_plain(*args)
        torch.cuda.synchronize()
        for part, a, b in zip(("H", "g", "rsum"), got[:3], want[:3]):
            scale = max(b.abs().max().item(), 1e-12)
            rel = (a - b).abs().max().item() / scale
            if rel > GN_REL_TOL:
                raise AssertionError(f"gn level {level} {part}: relative error {rel:.3g}")
            gn_err = max(gn_err, (a - b).abs().max().item())
            gn_rel = max(gn_rel, rel)
        n = obj.gray.numel()
        dcount = abs(int(got[3]) - int(want[3]))
        if dcount > max(2, GN_COUNT_TOL * n):
            raise AssertionError(f"gn level {level}: count {int(got[3])} vs {int(want[3])}")
        shape = tag + "x".join(map(str, obj.gray.shape))
        ms = timed(lambda: gn.gn_terms(*args))
        plain_ms = timed(lambda: gn.gn_terms_plain(*args))
        gn_times[shape] = (ms, plain_ms)
        phase("kernels", f"gn {shape}: count {int(got[3])} vs plain {int(want[3])}, "
                         f"max relative error so far {gn_rel:.3g}, "
                         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return gn_err, gn_rel


def compare_maps(name, got, want):
    """Share of pixels within MAP_VALUE_TOL and the max abs error."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    share = (err <= MAP_VALUE_TOL * (1.0 + want.abs())).double().mean().item()
    if share < MAP_SHARE:
        raise AssertionError(f"{name}: only {share:.4f} of pixels within tolerance")
    return err.max().item(), share


def kernel_phase(state, grays, masks, K, cfg, tag=""):
    """Each kernel vs its plain version at a monocular path's shapes, on the
    state a real run left behind (full ring) and the next frame: GN at every
    level, epipolar, regularize and the four frame builds the path runs
    (tracking frame, a frame with depth, the depth/sigma pair and one
    plane).  ``tag`` prefixes the labels.  Returns (one entry per kernel,
    with its times by shape; the frame builds' (error, ms, plain ms) by
    label)."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.models.frame import build_tracking_frame, normalize_gray, with_pose
    from dvo_tpu_torch.models.mapper import epipolar_fields
    from dvo_tpu_torch.models.tracker import track
    from dvo_tpu_torch.ops.cuda import epipolar, framebuild, regularize
    from dvo_tpu_torch.ops.depth_filter import draw_reset_depth

    dev = grays.device
    frame = build_tracking_frame(grays, masks, K, cfg.pyramid.levels, 0, state.frame_count)
    tr = track(frame, state.ref, cfg.tracker)
    frame = with_pose(frame, tr.xi, state.ref.xi)
    T_inv = lie.se3_exp(-tr.xi)
    results = []
    base = state.ref.base
    shape = "x".join(map(str, base.shape))

    # --- GN at every pyramid level (the finest carries the crop) ---
    gn_times = {}
    gn_err, gn_rel = check_gn(frame.scenes, state.ref.scenes, T_inv, cfg.tracker, gn_times, tag)
    ms, plain_ms = gn_times[tag + shape]
    results.append(dict(name="gn", route="cuda", source="dvo_tpu_torch/csrc/gn.cu",
                        replaces="dvo_tpu/ops/pallas/gn.py:45", max_abs_err=gn_err,
                        max_rel_err=gn_rel, ms=ms, plain_ms=plain_ms, times_by_shape=gn_times))

    # --- epipolar against the full ring ---
    hist = state.history
    if hist.count != hist.capacity:
        raise AssertionError(f"ring holds {hist.count} of {hist.capacity} keyframes")
    reset = draw_reset_depth(base.shape, cfg.mapper.depth_filter,
                             torch.Generator(device=dev).manual_seed(SEED), dev)
    fields, _ = epipolar_fields(frame.base, frame.xi, frame.relative_xi, base.depth,
                                base.sigma, state.ref.age, hist, reset, cfg.mapper)
    ring = (hist.gray, hist.gx, hist.gy, hist.gmask)
    got = epipolar.epipolar_update(fields, *ring, cfg.mapper)
    want = epipolar.epipolar_update_plain(fields, *ring, cfg.mapper)
    torch.cuda.synchronize()
    err_d, share_d = compare_maps("epipolar depth", got[0], want[0])
    err_s, _ = compare_maps("epipolar sigma", got[1], want[1])
    age_share = (got[2] == want[2]).double().mean().item()
    if age_share < MAP_SHARE:
        raise AssertionError(f"epipolar age: only {age_share:.4f} of pixels equal")
    for k, (a, b) in enumerate(zip(got[3].tolist(), want[3].tolist())):
        if abs(a - b) > max(2, STATS_TOL * b):
            raise AssertionError(f"epipolar stat {k}: {a} vs {b}")
    ms = timed(lambda: epipolar.epipolar_update(fields, *ring, cfg.mapper))
    plain_ms = timed(lambda: epipolar.epipolar_update_plain(fields, *ring, cfg.mapper))
    slots = torch.unique(fields[epipolar.F_SLOT][fields[epipolar.F_BASE_OK] > 0.5]).numel()
    phase("kernels", f"{tag}epipolar {shape}: stats {got[3].tolist()} vs plain {want[3].tolist()}, "
                     f"{slots} born slots in use, depth share {share_d:.5f}, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(name="epipolar", route="cuda", source="dvo_tpu_torch/csrc/epipolar.cu",
                        replaces="dvo_tpu/ops/pallas/epipolar.py:64",
                        max_abs_err=max(err_d, err_s), ms=ms, plain_ms=plain_ms,
                        times_by_shape={tag + shape: (ms, plain_ms)}))

    # --- regularize ---
    got = regularize.regularize(base.depth, base.sigma, cfg.mapper)
    want = regularize.regularize_plain(base.depth, base.sigma, cfg.mapper)
    torch.cuda.synchronize()
    err, share = compare_maps("regularize", got, want)
    ms = timed(lambda: regularize.regularize(base.depth, base.sigma, cfg.mapper))
    plain_ms = timed(lambda: regularize.regularize_plain(base.depth, base.sigma, cfg.mapper))
    phase("kernels", f"{tag}regularize {shape}: share {share:.5f}, max err {err:.3g}, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(name="regularize", route="cuda",
                        source="dvo_tpu_torch/csrc/regularize.cu",
                        replaces="dvo_tpu/ops/pallas/regularize.py:29",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        times_by_shape={tag + shape: (ms, plain_ms)}))

    # --- the frame builds: tracking frame, a keyframe with depth (the first
    # frame's), the depth/sigma pair (promotion) and one plane (regularize) ---
    levels = cfg.pyramid.levels
    gray = normalize_gray(grays)
    builds = {
        "tracking": (framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
                     gray, masks, None, None, levels),
        "depth": (framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
                  gray, masks, base.depth, base.sigma, levels),
        "pair": (framebuild.cull_pyramid_pair, framebuild.cull_pyramid_pair_plain,
                 base.depth, base.sigma, levels),
        "one": (framebuild.cull_pyramid_one, framebuild.cull_pyramid_one_plain,
                base.depth, levels),
    }
    fb = {}
    for kind, args in builds.items():
        label = f"{tag}{kind} {shape}x{levels}"
        fb[label] = check_framebuild(label, *args)
    return results, fb


def kinect_mono_kernel_phase(dev, grays, masks, counts, K, cfg):
    """The kernels at the shapes of ``--format kinect --mode mono``: the
    512x424 depth camera culled twice by ``DVOConfig.monocular()``, a
    106x128 base with 3 levels.  ``monocular_init_with_depth`` on the RGB-D
    frames, run KINECT_WARM frames at a time until the keyframe ring is
    full, then ``kernel_phase`` on the next frame."""
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init_with_depth,
        monocular_run,
        raw_depth,
    )

    K = K.to(dev)
    d0, s0 = raw_depth(counts[0].to(dev), DEPTH_SCALE)
    state = monocular_init_with_depth(grays[0].to(dev), masks[0].to(dev), d0, s0, K, cfg)
    i = 1
    while state.history.count < state.history.capacity:
        if i + KINECT_WARM >= grays.shape[0]:
            raise AssertionError(f"kinect mono: the ring holds {state.history.count} "
                                 f"keyframes after {i - 1} frames")
        sl = slice(i, i + KINECT_WARM)
        state, _ = monocular_run(state, grays[sl].to(dev), masks[sl].to(dev), K, cfg)
        i += KINECT_WARM
    cfg0, K0, (gray, mask) = _cull_chunk(cfg, K, grays[i].to(dev), masks[i].to(dev))
    phase("kernels", f"kinect mono: the ring full after {i - 1} frames")
    return kernel_phase(state, gray, mask, K0, cfg0, tag="kinect_mono ")


def rgbd_kernel_phase(dev, grays, masks, counts, K, cfg, gn_entry, fb):
    """GN at the four RGB-D levels and the RGB-D frame builds, on the first
    two frames of the RGB-D sequence; adds to the gn entry and to ``fb``."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.models.frame import build_frame_with_depth, normalize_gray
    from dvo_tpu_torch.models.odometry import _cull_chunk, raw_depth
    from dvo_tpu_torch.models.tracker import track
    from dvo_tpu_torch.ops.cuda import framebuild

    cfg0, K0, (g, m, c) = _cull_chunk(cfg, K.to(dev), grays[:2].to(dev), masks[:2].to(dev),
                                      counts[:2].to(dev))
    depths, sigmas = raw_depth(c, DEPTH_SCALE)
    levels = cfg.pyramid.levels
    ref = build_frame_with_depth(g[0], m[0], depths[0], sigmas[0], K0, levels, 0, 0)
    obj = build_frame_with_depth(g[1], m[1], depths[1], sigmas[1], K0, levels, 0, 1)
    tr = track(obj, ref, cfg0.tracker)
    gn_times = gn_entry["times_by_shape"]
    err, rel = check_gn(obj.scenes, ref.scenes, lie.se3_exp(-tr.xi), cfg0.tracker, gn_times)
    gn_entry["max_abs_err"] = max(gn_entry["max_abs_err"], err)
    gn_entry["max_rel_err"] = max(gn_entry["max_rel_err"], rel)

    holes = m[1] & (depths[1] > 0)
    if bool(holes.all()):
        raise AssertionError("the RGB-D build's mask has no holes")
    shape = f"{'x'.join(map(str, g[1].shape))}x{levels}"
    fb[f"rgbd {shape}"] = check_framebuild(
        f"rgbd {shape}", framebuild.build_pyramid_planes, framebuild.build_pyramid_planes_plain,
        normalize_gray(g[1]), holes, depths[1], sigmas[1], levels)
    fb[f"one {shape}"] = check_framebuild(
        f"one {shape}", framebuild.cull_pyramid_one, framebuild.cull_pyramid_one_plain,
        depths[1], levels)
    return f"rgbd {shape}"


def sync_stacks(fn, syncs: list):
    """Run ``fn()`` under ``set_sync_debug_mode("warn")``; appends the call
    stack of every host sync it issues to ``syncs`` and returns its result."""
    caught = []
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *_, **__: caught.append(
            (str(message), traceback.format_stack()[:-1]))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs.extend([f for f in stack if "warnings.py" not in f]
                 for message, stack in caught if "called a synchronizing" in message)
    return out


def count_syncs(fn) -> int:
    """Host syncs that ``fn()`` issues; the call stack of each goes to
    stderr."""
    syncs = []
    sync_stacks(fn, syncs)
    for stack in syncs:
        print("sync at:\n" + "".join(stack[-6:]), file=sys.stderr)
    return len(syncs)


def write_png(path, img) -> None:
    """``img`` as a PNG, written with the standard library's zlib (the card's
    machine may have no PIL): (H, W) uint8 or uint16 gray, or (H, W, 3)
    uint8 RGB; no interlace, filter 0 on every row."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    bits = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2" if bits == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, bits, 2 if img.ndim == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_sequence(root, grays, counts=None, colors=None) -> str:
    """An info.txt sequence under ``root``: gray frames, or "gray depth"
    pairs with 16-bit depth counts; ``colors`` replaces the gray frames by
    RGB ones (the Kinect color camera)."""
    os.makedirs(root)
    frames = grays if colors is None else colors
    with open(os.path.join(root, "info.txt"), "w") as f:
        for i, img in enumerate(frames):
            write_png(os.path.join(root, f"c{i:04d}.png"), img)
            line = f"c{i:04d}.png"
            if counts is not None:
                write_png(os.path.join(root, f"d{i:04d}.png"), counts[i])
                line += f" d{i:04d}.png"
            f.write(line + "\n")
    return root


def write_calib(path, sections, extrinsic=None) -> str:
    """A calibration YAML: ``sections`` maps a name to (K, width, height);
    no distortion; ``extrinsic`` a 4x4 depth-to-color transform."""
    fmt = lambda a: ", ".join(repr(float(v)) for v in np.asarray(a, np.float32).ravel())
    with open(path, "w") as f:
        for name, (K, w, h) in sections.items():
            f.write(f"{name}:\n  K: [{fmt(K)}]\n  resolution: [{w}, {h}]\n")
        if extrinsic is not None:
            f.write(f"extrinsic:\n  invT: [{fmt(extrinsic)}]\n")
    return path


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def fixed_resets(planes):
    """The runner's monocular steps take their depth-filter reset planes
    from ``planes``, in step order, in place of drawing them from the
    state's generator: the same numbers on either device."""
    from dvo_tpu_torch.utils import runner

    used = 0

    def take(n, device):
        nonlocal used
        out = planes[used:used + n].to(device)
        used += n
        return out

    step, run = runner.monocular_step, runner.monocular_run
    with patched(runner, "monocular_step", lambda state, *a, **k: step(
            state, *a, reset_depth=take(1, state.ref.xi.device)[0], **k)), \
            patched(runner, "monocular_run", lambda state, grays, *a, **k: run(
                state, grays, *a, reset_depths=take(len(grays), state.ref.xi.device), **k)):
        yield


def cli_path(name, argv):
    """``dvo_tpu_torch.run.main(argv)`` in this process, as ``python -m
    dvo_tpu_torch.run`` runs it, with every launch count set to 0 just
    before.  The runner's frame stream is timed (decode, plus the remap when
    there is one).  Returns a dict: the JSON report, the runner's
    (timestamps, poses, secs), the state it checkpointed, launches, wall and
    decode seconds."""
    from dvo_tpu_torch import run
    from dvo_tpu_torch.utils import checkpoint, runner

    got = {"decode_s": 0.0}
    stream = runner._image_stream

    def timed_stream(*args, **kwargs):
        frames = stream(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            item = next(frames, None)
            got["decode_s"] += time.perf_counter() - t0
            if item is None:
                return
            yield item

    def capture(key, fn):
        def wrapper(*args, **kwargs):
            got[key] = fn(*args, **kwargs)
            return got[key]
        return wrapper

    def keep_state(path, state):
        got["state"] = state
        save(path, state)

    save = checkpoint.save_state
    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(runner, "_image_stream", timed_stream))
        stack.enter_context(patched(checkpoint, "save_state", keep_state))
        for fn in ("run_rgbd", "run_monocular", "run_kinect"):
            stack.enter_context(patched(runner, fn, capture("result", getattr(runner, fn))))
        stack.enter_context(contextlib.redirect_stdout(out))
        rc, got["wall_s"], got["launches"] = run_path(name, lambda: run.main(argv))
    if rc != 0:
        raise AssertionError(f"cli {name}: main returned {rc}")
    got["report"] = json.loads(out.getvalue().strip().splitlines()[-1])
    return got


def cli_phase(dev, card_line, grays, K, r_grays, r_counts, r_K, cfg, cfg_r, by_path, resets):
    """``python -m dvo_tpu_torch.run`` on the card: the RGB-D (chunks of
    24), mono (chunks of 24, with a checkpoint) and Kinect (both modes,
    chunks of 3) paths on PNG sequences written from the frames the earlier
    phases rendered.  Returns per-path numbers for the kernels line."""
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_step,
        raw_depth,
        rgbd_init,
        rgbd_run_raw,
    )
    from dvo_tpu_torch.ops.depth_filter import draw_reset_depth
    from dvo_tpu_torch.utils import runner
    from dvo_tpu_torch.utils.checkpoint import load_state

    route = runner.decode_route()
    phase("cli", f"decode route: {route}")
    r_grays, r_counts = r_grays.numpy(), r_counts.numpy()
    summary = {"decode_route": route}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rgbd_dir = write_sequence(os.path.join(root, "rgbd"), r_grays, r_counts)
        mono_dir = write_sequence(os.path.join(root, "mono"), grays.cpu().numpy())
        # Kinect: the color camera sees the depth camera's view through a
        # focal length twice as long, at the centre of a 1920x1080 frame,
        # with an identity extrinsic; the registration at --kinect-gray-cull
        # 2 then lands on the depth view's own pixels.
        colors = np.zeros((KINECT_FRAMES, 1080, 1920, 3), np.uint8)
        view = np.repeat(np.repeat(r_grays[:KINECT_FRAMES], 2, axis=1), 2, axis=2)
        colors[:, 116:116 + 2 * RH, 448:448 + 2 * RW] = view[..., None]
        kin_dir = write_sequence(os.path.join(root, "kinect"), None, r_counts[:KINECT_FRAMES],
                                 colors)
        rK = r_K.numpy()
        cK = np.array([[2 * rK[0, 0], 0, 960], [0, 2 * rK[1, 1], 540], [0, 0, 1]], np.float32)
        rgbd_yaml = write_calib(os.path.join(root, "rgbd.yaml"), {"monocular": (rK, RW, RH)})
        mono_yaml = write_calib(os.path.join(root, "mono.yaml"),
                                {"monocular": (K.cpu().numpy(), W, H)})
        kin_yaml = write_calib(os.path.join(root, "kinect.yaml"),
                               {"rgb": (cK, 1920, 1080), "depth": (rK, RW, RH)}, np.eye(4))
        phase("cli", f"wrote the PNG sequences in {time.perf_counter() - t0:.2f} s")

        def run(name, data, calib, chunk, *extra):
            got = cli_path(name, ["--data", data, "--calib", calib, "--chunk", str(chunk),
                                  "--out", os.path.join(root, f"{name}.txt"), *extra])
            ts, poses, _ = got["result"]
            if not np.isfinite(poses).all():
                raise AssertionError(f"cli {name}: non-finite pose")
            kernels = ("gn", "epipolar", "regularize", "framebuild") if "mono" in name \
                else ("gn", "framebuild")
            require_launched(name, got["launches"], kernels)
            if "mono" not in name and (got["launches"]["epipolar"]
                                       or got["launches"]["regularize"]):
                raise AssertionError(f"{name}: the mapper's kernels ran: {got['launches']}")
            by_path[name] = got["launches"]
            n = len(ts) - 1
            wall, decode = got["wall_s"], got["decode_s"]
            summary[name] = dict(frames=n, ms_per_frame=1e3 * wall / n, wall_s=wall,
                                 decode_s=decode, dispatch_drain_s=wall - decode,
                                 report_fps=got["report"]["fps"])
            phase("cli", f"{name}: {n} frames after the first, {1e3 * wall / n:.3f} ms/frame "
                         f"(wall {wall:.2f} s: decode {decode:.2f} s = "
                         f"{100 * decode / wall:.1f}%, dispatch/drain {wall - decode:.2f} s), "
                         f"report fps {got['report']['fps']}, launches {got['launches']} "
                         f"on {card_line}")
            return got

        # RGB-D, with every host sync recorded and placed by its call stack.
        stacks = []
        rgbd = sync_stacks(lambda: run("cli_rgbd", rgbd_dir, rgbd_yaml, CLI_CHUNK,
                                       "--mode", "rgbd"), stacks)
        where = lambda stack, fn: any("runner.py" in f and f", in {fn}\n" in f for f in stack)
        in_dispatch = [s for s in stacks if where(s, "dispatch") or where(s, "upload")]
        in_chunks = [s for s in stacks if where(s, "_run_chunks")]
        for stack in in_dispatch:
            print("sync inside a chunk's dispatch:\n" + "".join(stack[-6:]), file=sys.stderr)
        n_chunks = RGBD_FRAMES // CLI_CHUNK
        summary["cli_rgbd"]["syncs"] = dict(in_dispatch=len(in_dispatch),
                                            in_chunk_loop=len(in_chunks), total=len(stacks),
                                            chunks=n_chunks)
        phase("cli", f"cli_rgbd host syncs: {len(in_dispatch)} inside the dispatch of "
                     f"{n_chunks} chunks, {len(in_chunks)} in the chunk loop outside it, "
                     f"{len(stacks)} in all (init, per-frame tail, result copies)")
        if in_dispatch:
            raise AssertionError("cli_rgbd: host sync inside a chunk's dispatch")

        # The API on the same frames as the CLI sees them (no undistortion:
        # an all-valid mask), one chunk.
        ones = torch.ones((RH, RW), dtype=torch.bool)
        d0, s0 = raw_depth(torch.from_numpy(r_counts[0]).to(dev), DEPTH_SCALE)
        api = rgbd_run_raw(rgbd_init(torch.from_numpy(r_grays[0]), ones, d0, s0, r_K, cfg_r,
                                     device=dev),
                           torch.from_numpy(r_grays[1:]), ones, torch.from_numpy(r_counts[1:]),
                           r_K, cfg_r, depth_scale=DEPTH_SCALE)[1]
        dT = np.abs(rgbd["result"][1][1:] - api.T_world.cpu().numpy()).max()
        phase("cli", f"cli_rgbd vs rgbd_init + rgbd_run_raw on the same frames: "
                     f"max |dT| {dT:.3g} (tol {POSE_TOL})")
        if not dT <= POSE_TOL:
            raise AssertionError("cli_rgbd: the CLI's poses differ from the API's")

        # Mono, with a checkpoint of the final state.
        ckpt = os.path.join(root, "state.npz")
        mono = run("cli_mono", mono_dir, mono_yaml, CLI_CHUNK, "--mode", "mono",
                   "--checkpoint", ckpt, "--metrics", os.path.join(root, "mono.jsonl"))
        live, loaded = mono["state"], load_state(ckpt, dev)
        cfg0, K0, (g, m) = _cull_chunk(cfg, K, grays[1], torch.ones((H, W), dtype=torch.bool,
                                                                    device=dev))
        step_live = monocular_step(live, g, m, K0, cfg0, resets[0].to(dev))[1]
        step_loaded = monocular_step(loaded, g, m, K0, cfg0, resets[0].to(dev))[1]
        dT = (step_live.T_world - step_loaded.T_world).abs().max().item()
        same_kf = bool(step_live.is_keyframe) == bool(step_loaded.is_keyframe)
        phase("cli", f"cli_mono checkpoint: {loaded.history.count} keyframes in the ring, "
                     f"next step live vs reloaded max |dT| {dT:.3g} (tol {POSE_TOL}), "
                     f"keyframe flags equal: {same_kf}")
        if not same_kf or not dT <= POSE_TOL:
            raise AssertionError("cli_mono: the reloaded checkpoint steps differently")

        base = (RH >> cfg.pyramid.culls, RW >> cfg.pyramid.culls)
        for mode in ("rgbd", "mono"):
            got = run(f"cli_kinect_{mode}", kin_dir, kin_yaml, KINECT_CHUNK,
                      "--format", "kinect", "--mode", mode)
            if mode == "rgbd":
                dT = np.abs(got["result"][1] - rgbd["result"][1][:KINECT_FRAMES]).max()
                phase("cli", f"cli_kinect_rgbd vs cli_rgbd on the same frames (registered "
                             f"gray, holes masked): max |dT| {dT:.3g} (tol {KINECT_GAP_TOL})")
                if not dT <= KINECT_GAP_TOL:
                    raise AssertionError("cli_kinect_rgbd: strays from the RGB-D CLI's poses")
            # The same command on the card and on the CPU (plain versions,
            # unpinned staging) over the first frames, one chunk and a
            # one-frame tail, both fed the same reset planes: the batched
            # registration and the pinned 1080p staging against the CPU's.
            poses = {}
            for device in ("cuda", "cpu"):
                planes = draw_reset_depth((KINECT_CPU_FRAMES - 1,) + base,
                                          cfg.mapper.depth_filter,
                                          torch.Generator().manual_seed(SEED))
                with fixed_resets(planes):
                    poses[device] = cli_path(f"cli_kinect_{mode}_{device}", [
                        "--data", kin_dir, "--calib", kin_yaml, "--format", "kinect",
                        "--mode", mode, "--chunk", str(KINECT_CHUNK),
                        "--max-frames", str(KINECT_CPU_FRAMES), "--device", device,
                        "--out", os.path.join(root, f"kinect_{mode}_{device}.txt")])["result"][1]
            dT = np.abs(poses["cuda"] - poses["cpu"]).max()
            summary[f"cli_kinect_{mode}"]["cuda_vs_cpu_max_dT"] = float(dT)
            phase("cli", f"cli_kinect_{mode}: the first {KINECT_CPU_FRAMES} frames on the card "
                         f"vs on the CPU: max |dT| {dT:.3g} (tol {POSE_TOL})")
            if not dT <= POSE_TOL:
                raise AssertionError(f"cli_kinect_{mode}: CUDA and CPU runs disagree")
    return summary


def run_path(name, fn):
    """Run one path with every launch count set to 0 just before; returns
    (its output, seconds, the counts read just after)."""
    from dvo_tpu_torch.ops.cuda import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.LAUNCHES)


def require_launched(path, launches, names):
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the {path} path")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init,
        monocular_init_with_depth,
        monocular_run,
        raw_depth,
        rgbd_init,
        rgbd_run_raw,
    )
    from dvo_tpu_torch.ops.cuda import _build

    # 1. device
    dev = torch.device("cuda", 0)
    card_line = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {card_line} | "
                    f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", f"nvcc build + load {time.perf_counter() - t0:.2f} s -> "
                   f"{_build.library_path().name}")

    cfg = DVOConfig.monocular()
    grays, masks, K, depth = render_sequence(dev)
    gen = torch.Generator().manual_seed(SEED)  # CPU: the same numbers for both runs
    h0, w0 = H >> cfg.pyramid.culls, W >> cfg.pyramid.culls
    noise = torch.randn((h0, w0), generator=gen)
    resets = torch.clamp(0.5 + 1.5 * torch.rand((N_FRAMES, h0, w0), generator=gen), max=4.0)

    def init(device):
        return monocular_init(grays[0].to(device), masks[0].to(device), K.to(device), cfg,
                              noise=noise.to(device))

    # 3. kernels, on the state a warm-up run leaves (ring filled by promotions)
    warm, _ = monocular_run(init(dev), grays[1:1 + CHUNK], masks[1:1 + CHUNK], K, cfg,
                            resets[:CHUNK].to(dev))
    nxt = 1 + CHUNK
    cfg0, K0, (gray_next, mask_next) = _cull_chunk(cfg, K, grays[nxt], masks[nxt])
    kernels, fb = kernel_phase(warm, gray_next, mask_next, K0, cfg0)
    cfg_r = DVOConfig.rgbd()
    r_grays, r_masks, r_counts, r_K = render_rgbd(dev)
    rgbd_label = rgbd_kernel_phase(dev, r_grays, r_masks, r_counts, r_K, cfg_r, kernels[0], fb)
    kin_kernels, kin_fb = kinect_mono_kernel_phase(dev, r_grays, r_masks, r_counts, r_K, cfg)
    for entry, more in zip(kernels, kin_kernels):
        for key in ("max_abs_err", "max_rel_err"):
            if key in more:
                entry[key] = max(entry[key], more[key])
        entry["times_by_shape"].update(more["times_by_shape"])
    fb.update(kin_fb)

    # 4. main path
    def mono_main():
        state, outs = init(dev), []
        for c in range(0, N_FRAMES, CHUNK):
            sl = slice(1 + c, 1 + c + CHUNK)
            state, res = monocular_run(state, grays[sl], masks[sl], K, cfg,
                                       resets[c:c + CHUNK].to(dev))
            outs.append(res)
        return outs

    outs, elapsed, launches = run_path("mono", mono_main)
    T = torch.cat([r.T_world for r in outs])
    kf = torch.cat([r.is_keyframe for r in outs])
    accepted = torch.cat([r.mapping.accepted for r in outs])
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("non-finite pose")
    if not bool(kf.any()):
        raise AssertionError("no keyframe promotion")
    if not bool((accepted[~kf] > 0).any()):
        raise AssertionError("no depth update accepted an observation")
    require_launched("mono", launches, launches)
    ms_frame = 1e3 * elapsed / N_FRAMES
    by_path = {"mono": launches}
    phase("main", f"{N_FRAMES} frames 640x480 -> 160x120, {int(kf.sum())} promotions, "
                  f"accepted per update {accepted[~kf].tolist()}, launches {launches}, "
                  f"{ms_frame:.3f} ms/frame = {1e3 / ms_frame:.2f} fps on {card_line}")

    # 5. the first frames on the CPU with the plain versions
    cpu_state = init("cpu")
    _, cpu_res = monocular_run(cpu_state, grays[1:1 + CPU_FRAMES].cpu(),
                               masks[1:1 + CPU_FRAMES].cpu(), K.cpu(), cfg,
                               resets[:CPU_FRAMES])
    dT = (T[:CPU_FRAMES].cpu() - cpu_res.T_world).abs().max().item()
    same_kf = bool((kf[:CPU_FRAMES].cpu() == cpu_res.is_keyframe).all())
    phase("cpu", f"first {CPU_FRAMES} frames: max |T_cuda - T_cpu| {dT:.3g} (tol {POSE_TOL}), "
                 f"keyframes cuda {kf[:CPU_FRAMES].int().tolist()} "
                 f"cpu {cpu_res.is_keyframe.int().tolist()}")
    if not same_kf or not dT <= POSE_TOL:
        raise AssertionError("CUDA and CPU runs disagree")

    # 6. RGB-D: frame 0 converted as rgbd_run_raw converts, then one chunk
    def rgbd_start(device):
        d0, s0 = raw_depth(r_counts[0].to(device), DEPTH_SCALE)
        return rgbd_init(r_grays[0], r_masks[0], d0, s0, r_K, cfg_r, device=device)

    def rgbd_main(device, n):
        return rgbd_run_raw(rgbd_start(device), r_grays[1:1 + n], r_masks[1:1 + n],
                            r_counts[1:1 + n], r_K, cfg_r, depth_scale=DEPTH_SCALE)[1]

    res_r, elapsed, launches = run_path("rgbd", lambda: rgbd_main(dev, RGBD_FRAMES))
    by_path["rgbd"] = launches
    if not bool(torch.isfinite(res_r.T_world).all()):
        raise AssertionError("rgbd: non-finite pose")
    step = torch.tensor(RGBD_STEP, device=dev)
    step_err = torch.linalg.vector_norm(res_r.relative_xi - step, dim=1)
    require_launched("rgbd", launches, ("gn", "framebuild"))
    if launches["epipolar"] or launches["regularize"]:
        raise AssertionError(f"rgbd: the mapper's kernels ran: {launches}")
    ms_rgbd = 1e3 * elapsed / RGBD_FRAMES
    phase("rgbd", f"{RGBD_FRAMES} frames {RW}x{RH} -> {RW >> 1}x{RH >> 1} x {cfg_r.pyramid.levels} "
                  f"levels (uint8 gray, uint16 depth), twist error vs step: max "
                  f"{step_err.max().item():.3g} median {step_err.median().item():.3g} "
                  f"(tol {STEP_TOL}), GN iterations per frame "
                  f"{res_r.tracking.iterations.sum(1).float().mean().item():.1f}, "
                  f"launches {launches}, {ms_rgbd:.3f} ms/frame = {1e3 / ms_rgbd:.2f} fps "
                  f"on {card_line}")
    if not step_err.max().item() <= STEP_TOL:
        raise AssertionError("rgbd: a frame-to-frame twist missed the step")
    cpu_r = rgbd_main("cpu", CPU_FRAMES)
    dT_r = (res_r.T_world[:CPU_FRAMES].cpu() - cpu_r.T_world).abs().max().item()
    same_iters = bool((res_r.tracking.iterations[:CPU_FRAMES].cpu()
                       == cpu_r.tracking.iterations).all())
    phase("rgbd", f"first {CPU_FRAMES} frames on the CPU: max |T_cuda - T_cpu| {dT_r:.3g} "
                  f"(tol {POSE_TOL}), GN iterations equal: {same_iters}")
    if not dT_r <= POSE_TOL:
        raise AssertionError("rgbd: CUDA and CPU runs disagree")

    # 7. the monocular pipeline seeded with measured depth
    def mono_depth_main():
        sigma0 = torch.full_like(depth, 0.1)
        state = monocular_init_with_depth(grays[0], masks[0], depth, sigma0, K, cfg)
        n = MONO_DEPTH_FRAMES
        return monocular_run(state, grays[1:1 + n], masks[1:1 + n], K, cfg,
                             resets[:n].to(dev))[1]

    res_d, elapsed, launches = run_path("monodepth", mono_depth_main)
    by_path["monodepth"] = launches
    if not bool(torch.isfinite(res_d.T_world).all()):
        raise AssertionError("monodepth: non-finite pose")
    require_launched("monodepth", launches, launches)
    phase("monodepth", f"{MONO_DEPTH_FRAMES} frames 640x480, "
                       f"{int(res_d.is_keyframe.sum())} promotions, launches {launches}, "
                       f"{1e3 * elapsed / MONO_DEPTH_FRAMES:.3f} ms/frame")

    # 8. host syncs per frame, inputs already on the card
    # (a copy from pageable host memory syncs, so nothing is shipped inside)
    n = SYNC_FRAMES
    d_grays, d_masks, d_counts = (x[1:1 + n].to(dev) for x in (r_grays, r_masks, r_counts))
    d_K, d_resets = r_K.to(dev), resets[:n].to(dev)
    state_r = rgbd_start(dev)
    syncs_rgbd = count_syncs(lambda: rgbd_run_raw(state_r, d_grays, d_masks, d_counts, d_K,
                                                  cfg_r, depth_scale=DEPTH_SCALE))
    state_m = init(dev)
    syncs_mono = count_syncs(lambda: monocular_run(state_m, grays[1:1 + n], masks[1:1 + n], K,
                                                   cfg, d_resets))
    phase("syncs", f"per frame over {n} frames: rgbd {syncs_rgbd / n:g}, mono {syncs_mono / n:g}")
    if syncs_rgbd != 0 or syncs_mono != n:
        raise AssertionError("host syncs: expected none on rgbd and one per mono frame")

    # 9. the CLI, python -m dvo_tpu_torch.run, on PNG sequences
    cli = cli_phase(dev, card_line, grays, K, r_grays, r_counts, r_K, cfg, cfg_r, by_path,
                    resets)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    _, ms, plain_ms = fb[rgbd_label]
    kernels.append(dict(name="framebuild", route="cuda", source="dvo_tpu_torch/csrc/framebuild.cu",
                        replaces="dvo_tpu/ops/pallas/framebuild.py:103",
                        max_abs_err=max(v[0] for v in fb.values()),
                        ms=ms, plain_ms=plain_ms,
                        ms_by_shape={k: v[1] for k, v in fb.items()},
                        plain_ms_by_shape={k: v[2] for k, v in fb.items()}))
    for k in kernels:
        if "times_by_shape" in k:
            times = k.pop("times_by_shape")
            k["ms_by_shape"] = {s: v[0] for s, v in times.items()}
            k["plain_ms_by_shape"] = {s: v[1] for s, v in times.items()}
        k["launches"] = sum(p[k["name"]] for p in by_path.values())
        k["launches_by_path"] = {path: p[k["name"]] for path, p in by_path.items()}
    print(json.dumps({"kernels": kernels, "ms_per_frame": ms_frame, "rgbd_ms_per_frame": ms_rgbd,
                      "syncs_per_frame": {"mono": syncs_mono / n, "rgbd": syncs_rgbd / n},
                      "cli": cli, "card": card_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
