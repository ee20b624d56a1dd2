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
                212x256 (RGB-D), epipolar at 120x160 with the full 8-slot
                ring, regularize at 120x160, and the frame build (held equal
                with ``torch.equal``) for the RGB-D build at 212x256 x 4
                levels, the mono tracking build at 120x160 x 3, the depth/
                sigma pair at 120x160 and one plane at 212x256; times from
                CUDA events.
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
Each path's launch counts are set to 0 just before it runs and read just
after.  Then a JSON line of per-kernel results and, last, the device JSON
line.  Any failure raises (exit code != 0) before the last line is printed.
It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings

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


def check_gn(obj_scenes, ref_scenes, T_inv, cfg, gn_times):
    """GN kernel vs plain at every level; fills gn_times[shape] and returns
    (max abs error, max relative error)."""
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
        shape = "x".join(map(str, obj.gray.shape))
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


def kernel_phase(state, grays, masks, K, cfg):
    """Each kernel vs its plain version at the main path's shapes, on the
    state a real run left behind (full ring) and the next frame."""
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

    # --- GN at every pyramid level (the finest carries the crop) ---
    gn_times = {}
    gn_err, gn_rel = check_gn(frame.scenes, state.ref.scenes, T_inv, cfg.tracker, gn_times)
    ms, plain_ms = gn_times["120x160"]
    results.append(dict(name="gn", route="cuda", source="dvo_tpu_torch/csrc/gn.cu",
                        replaces="dvo_tpu/ops/pallas/gn.py:45", max_abs_err=gn_err,
                        max_rel_err=gn_rel, ms=ms, plain_ms=plain_ms, times_by_shape=gn_times))

    # --- epipolar at 120x160 against the full ring ---
    hist = state.history
    if hist.count != hist.capacity:
        raise AssertionError(f"ring holds {hist.count} of {hist.capacity} keyframes")
    base = state.ref.base
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
    phase("kernels", f"epipolar 120x160: stats {got[3].tolist()} vs plain {want[3].tolist()}, "
                     f"{slots} born slots in use, depth share {share_d:.5f}, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(name="epipolar", route="cuda", source="dvo_tpu_torch/csrc/epipolar.cu",
                        replaces="dvo_tpu/ops/pallas/epipolar.py:64",
                        max_abs_err=max(err_d, err_s), ms=ms, plain_ms=plain_ms))

    # --- regularize at 120x160 ---
    got = regularize.regularize(base.depth, base.sigma, cfg.mapper)
    want = regularize.regularize_plain(base.depth, base.sigma, cfg.mapper)
    torch.cuda.synchronize()
    err, share = compare_maps("regularize", got, want)
    ms = timed(lambda: regularize.regularize(base.depth, base.sigma, cfg.mapper))
    plain_ms = timed(lambda: regularize.regularize_plain(base.depth, base.sigma, cfg.mapper))
    phase("kernels", f"regularize 120x160: share {share:.5f}, max err {err:.3g}, "
                     f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append(dict(name="regularize", route="cuda",
                        source="dvo_tpu_torch/csrc/regularize.cu",
                        replaces="dvo_tpu/ops/pallas/regularize.py:29",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # --- the frame build at the mono shapes: tracking frame, depth/sigma pair ---
    levels = cfg.pyramid.levels
    fb = {}
    fb["tracking 120x160x3"] = check_framebuild(
        "tracking 120x160x3", framebuild.build_pyramid_planes,
        framebuild.build_pyramid_planes_plain, normalize_gray(grays), masks, None, None, levels)
    fb["pair 120x160x3"] = check_framebuild(
        "pair 120x160x3", framebuild.cull_pyramid_pair, framebuild.cull_pyramid_pair_plain,
        base.depth, base.sigma, levels)
    return results, fb


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


def count_syncs(fn) -> int:
    """Host syncs that ``fn()`` issues, from ``set_sync_debug_mode``; the
    call stack of each goes to stderr."""
    stacks = []
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda message, *_, **__: stacks.append(
            (str(message), traceback.format_stack()[:-1]))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [[f for f in stack if "warnings.py" not in f]
             for message, stack in stacks if "called a synchronizing" in message]
    for stack in syncs:
        print("sync at:\n" + "".join(stack[-6:]), file=sys.stderr)
    return len(syncs)


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

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    err, ms, plain_ms = fb[rgbd_label]
    kernels.append(dict(name="framebuild", route="cuda", source="dvo_tpu_torch/csrc/framebuild.cu",
                        replaces="dvo_tpu/ops/pallas/framebuild.py:103", max_abs_err=err,
                        ms=ms, plain_ms=plain_ms,
                        ms_by_shape={k: v[1] for k, v in fb.items()},
                        plain_ms_by_shape={k: v[2] for k, v in fb.items()}))
    gn_times = kernels[0].pop("times_by_shape")
    kernels[0]["ms_by_shape"] = {k: v[0] for k, v in gn_times.items()}
    kernels[0]["plain_ms_by_shape"] = {k: v[1] for k, v in gn_times.items()}
    for k in kernels:
        k["launches"] = sum(p[k["name"]] for p in by_path.values())
        k["launches_by_path"] = {path: p[k["name"]] for path, p in by_path.items()}
    print(json.dumps({"kernels": kernels, "ms_per_frame": ms_frame, "rgbd_ms_per_frame": ms_rgbd,
                      "syncs_per_frame": {"mono": syncs_mono / n, "rgbd": syncs_rgbd / n},
                      "card": card_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
