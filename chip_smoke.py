#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dvo_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, one line each:
  1. device   — the card's name and power limit (nvidia-smi); TF32 off.
  2. build    — compile ``dvo_tpu_torch/csrc/*.cu`` with nvcc (first use).
  3. kernels  — each kernel against its plain PyTorch version on the card,
                on inputs from a real run at the main path's shapes: GN at
                30x40, 60x80 and 120x160, epipolar at 120x160 with the full
                8-slot ring, regularize at 120x160; times from CUDA events.
  4. main     — ``monocular_init`` + ``monocular_run`` with
                ``DVOConfig.monocular()`` on 48 synthetic 640x480 uint8
                frames (chunks of 24); every kernel must have launched.
  5. cpu      — the first 8 frames again on the CPU (plain versions, same
                bootstrap noise and reset planes); poses and keyframe flags
                must agree with the CUDA run.
Then a JSON line of per-kernel results and, last, the device JSON line.
Any failure raises (exit code != 0) before the last line is printed.
It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_FRAMES = 48           # frames after the first (keyframe) one
CHUNK = 24
CPU_FRAMES = 8
H, W = 480, 640
STEP_XI = (0.014, 0.004, 0.006, 0.001, -0.002, 0.001)  # per-frame motion

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


def render_sequence(device):
    """N_FRAMES + 1 frames of a static textured scene under constant small
    motion, rendered with the port's inverse warp; uint8, 640x480."""
    from dvo_tpu_torch import lie
    from dvo_tpu_torch.ops.warp import warp_image

    rng = np.random.default_rng(SEED)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.zeros((H, W), np.float32)
    for _ in range(8):
        fx, fy = rng.uniform(0.04, 0.2, 2)
        ph = rng.uniform(0, 6.28, 2)
        base += rng.uniform(0.5, 1.0) * np.sin(fx * xs + ph[0]) * np.sin(fy * ys + ph[1])
    base = (base - base.min()) / (base.max() - base.min())
    smooth = np.zeros((H, W), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.002, 0.01, 2)
        smooth += np.sin(fx * xs + rng.uniform(0, 6.28)) * np.sin(fy * ys + rng.uniform(0, 6.28))
    depth = (1.5 + 0.1 * smooth).astype(np.float32)
    K = torch.tensor([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], device=device)

    base_t = torch.from_numpy(base).to(device)
    depth_t = torch.from_numpy(depth).to(device)
    ones = torch.ones((H, W), dtype=torch.bool, device=device)
    step = torch.tensor(STEP_XI, dtype=torch.float32, device=device)
    xi = torch.zeros(6, dtype=torch.float32, device=device)
    grays, masks = [base_t], [ones]
    for _ in range(N_FRAMES):
        xi = lie.compose(xi, step)
        img, mask = warp_image(xi, base_t, ones, depth_t, K)
        grays.append(img)
        masks.append(mask)
    grays = torch.clamp(torch.round(torch.stack(grays) * 255.0), 0, 255).to(torch.uint8)
    return grays, torch.stack(masks), K


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
    from dvo_tpu_torch.models.frame import build_tracking_frame, with_pose
    from dvo_tpu_torch.models.mapper import epipolar_fields
    from dvo_tpu_torch.models.tracker import track
    from dvo_tpu_torch.ops.cuda import epipolar, gn, regularize
    from dvo_tpu_torch.ops.depth_filter import draw_reset_depth

    dev = grays.device
    frame = build_tracking_frame(grays, masks, K, cfg.pyramid.levels, 0, state.frame_count)
    tr = track(frame, state.ref, cfg.tracker)
    frame = with_pose(frame, tr.xi, state.ref.xi)
    T_inv = lie.se3_exp(-tr.xi)
    results = []

    # --- GN at every pyramid level (the finest carries the crop) ---
    gn_err, gn_rel, gn_times = 0.0, 0.0, {}
    for level, (obj, ref) in enumerate(zip(frame.scenes, state.ref.scenes)):
        args = (obj.gray, obj.mask, ref.depth, ref.sigma, ref.gray, ref.mask,
                ref.gx, ref.gy, ref.gmask, ref.K, T_inv, level, cfg.tracker)
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
    ms, plain_ms = gn_times["120x160"]
    results.append(dict(name="gn", route="cuda", source="dvo_tpu_torch/csrc/gn.cu",
                        replaces="dvo_tpu/ops/pallas/gn.py:45", max_abs_err=gn_err,
                        max_rel_err=gn_rel, ms=ms, plain_ms=plain_ms,
                        ms_by_shape={k: v[0] for k, v in gn_times.items()},
                        plain_ms_by_shape={k: v[1] for k, v in gn_times.items()}))

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
    return results


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.odometry import _cull_chunk, monocular_init, monocular_run
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
    grays, masks, K = render_sequence(dev)
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
    kernels = kernel_phase(warm, gray_next, mask_next, K0, cfg0)

    # 4. main path
    state = init(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = []
    for c in range(0, N_FRAMES, CHUNK):
        sl = slice(1 + c, 1 + c + CHUNK)
        state, res = monocular_run(state, grays[sl], masks[sl], K, cfg,
                                   resets[c:c + CHUNK].to(dev))
        outs.append(res)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    T = torch.cat([r.T_world for r in outs])
    kf = torch.cat([r.is_keyframe for r in outs])
    accepted = torch.cat([r.mapping.accepted for r in outs])
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("non-finite pose")
    if not bool(kf.any()):
        raise AssertionError("no keyframe promotion")
    if not bool((accepted[~kf] > 0).any()):
        raise AssertionError("no depth update accepted an observation")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    ms_frame = 1e3 * elapsed / N_FRAMES
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

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels, "ms_per_frame": ms_frame, "card": card_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
