"""Where one GN step's time goes inside ``csrc/gn_level.cu``.

Run from the repository root on a machine with a CUDA card:

    python3 -m dvo_tpu_torch.tools.gn_level_stamps

Builds ``csrc/gn_level.cu`` once more with ``-DDVO_GN_LEVEL_STAMPS`` into the
git-ignored build directory, at 512 threads a block (the kernel's own) and
at 256 and 1024: the solver thread (block 0, thread 0) then stamps
``clock64()`` at six points of every step.  Runs 15 steps that never
converge (both thresholds 0) at each level of ``chip_smoke.py``'s RGB-D rig
and prints, per thread count and level, the median SM cycles of each part
of a step, beside the card's maximum SM clock (a launch this short does not
hold the clock that ``nvidia-smi`` samples, so the cycles are not
converted).

    python3 -m dvo_tpu_torch.tools.gn_level_stamps --baseline DIR

instead builds ``DIR/dvo_tpu_torch/csrc/gn_level.cu`` (an earlier tree,
unpacked with ``git archive <commit> dvo_tpu_torch/csrc | tar -x -C DIR``)
and holds this tree's level kernel against it bit for bit: every output of
a 15-step level at every level of ``chip_smoke.py``'s mono and RGB-D rigs'
first two frames.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import torch

STEPS = 15
THREADS = (512, 256, 1024)
PARTS = ("pose copy + pixels", "warp and block sums", "barrier 1", "cluster sum + solve",
         "barrier 2", "loop")


def build_with_stamps(threads_per_block):
    """One library per thread count, all ``nvcc`` processes at once."""
    from dvo_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [_build.BUILD_DIR / f"libdvo_gn_level_stamps_{t}.{os.getpid()}.so"
            for t in threads_per_block]
    procs = [subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-DDVO_GN_LEVEL_STAMPS",
         f"-DDVO_GN_LEVEL_THREADS={t}", "-shared", "-I", str(_build.SOURCE_DIR), "-o", str(out),
         str(_build.SOURCE_DIR / "gn_level.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for t, out in zip(threads_per_block, outs)]
    libs = []
    for proc, out in zip(procs, outs):
        stderr = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{stderr}")
        lib = ctypes.CDLL(str(out))
        out.unlink()
        argtypes, restype = _build._SIGNATURES["dvo_gn_level"]
        lib.dvo_gn_level.argtypes, lib.dvo_gn_level.restype = argtypes, restype
        libs.append(lib)
    return libs


def build_baseline_level(tree):
    """An earlier tree's ``gn_level.cu``, from its own sources, bound with
    this tree's signature of ``dvo_gn_level``."""
    from pathlib import Path

    from dvo_tpu_torch.ops.cuda import _build

    src = Path(tree) / "dvo_tpu_torch" / "csrc"
    out = _build.BUILD_DIR / f"libdvo_gn_level_baseline.{os.getpid()}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(src), "-o",
                           str(out), str(src / "gn_level.cu")], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}) for the baseline:\n{done.stderr}")
    lib = _build.bind(ctypes.CDLL(str(out)), ["dvo_gn_level"])
    out.unlink()
    return lib


def level_kernel_against(tree, cs, dev):
    """This tree's level kernel against ``tree``'s on the mono and RGB-D
    rigs: every output equal bit for bit.  Returns the levels compared."""
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.frame import build_frame_with_depth, build_tracking_frame
    from dvo_tpu_torch.models.odometry import _cull_chunk, monocular_init, raw_depth
    from dvo_tpu_torch.models.tracker import level_planes
    from dvo_tpu_torch.ops.cuda import _build, gn_level

    base = build_baseline_level(tree)
    pairs = []
    cfg = DVOConfig.monocular()
    grays, masks, K, _ = cs.render_sequence(dev)
    state = monocular_init(grays[0], masks[0], K, cfg, device=dev)
    cfg0, K0, (g, m) = _cull_chunk(cfg, K, grays[1], masks[1])
    frame = build_tracking_frame(g, m, K0, cfg.pyramid.levels, 0, 1)
    pairs.append(("mono", frame, state.ref, cfg0.tracker))
    cfg_r = DVOConfig.rgbd()
    r_grays, r_masks, r_counts, r_K = cs.render_rgbd(dev)
    cfg_rc, K_r, (g, m, c) = _cull_chunk(cfg_r, r_K.to(dev), *(
        x[:2].to(dev) for x in (r_grays, r_masks, r_counts)))
    d, sg = raw_depth(c, cs.DEPTH_SCALE)
    levels = cfg_r.pyramid.levels
    ref = build_frame_with_depth(g[0], m[0], d[0], sg[0], K_r, levels, 0, 0)
    obj = build_frame_with_depth(g[1], m[1], d[1], sg[1], K_r, levels, 0, 1)
    pairs.append(("rgbd", obj, ref, cfg_rc.tracker))
    compared = []
    for label, obj, ref, cfg_t in pairs:
        xi0 = torch.zeros(6, device=dev)
        for level in range(len(ref.scenes)):
            planes = level_planes(obj.scenes[level], ref.scenes[level])
            Kl = ref.scenes[level].K
            new = gn_level.gn_level(planes, Kl, xi0, level, cfg_t)
            n = cfg_t.max_iterations
            floats = torch.empty(6 + 2 * n, device=dev)
            ints = torch.empty(n + 1, dtype=torch.int32, device=dev)
            h, w = planes[0].shape
            code = base.dvo_gn_level(
                *(p.data_ptr() for p in planes), Kl.data_ptr(), xi0.data_ptr(),
                floats.data_ptr(), floats[6:].data_ptr(), floats[6 + n:].data_ptr(),
                ints.data_ptr(), ints[n:].data_ptr(), None, h, w,
                cfg_t.level_steps[min(level, len(cfg_t.level_steps) - 1)], cfg_t.min_depth,
                cfg_t.sigma_clamp[0], cfg_t.sigma_clamp[1], int(cfg_t.compat_weight_b_only),
                int(level == cfg_t.crop_level), cfg_t.crop_x[0], cfg_t.crop_x[1],
                cfg_t.crop_y[0], cfg_t.crop_y[1], n, cfg_t.damping, cfg_t.min_update_norm,
                cfg_t.min_residual, _build.stream_handle(dev))
            _build.check(code, "gn_level (baseline)")
            old = (floats[:6], floats[6:6 + n], floats[6 + n:], ints[:n], ints[n])
            same = all(torch.equal(a, b) for a, b in zip(new, old))
            print(f"gn_level {label} level {level} {h}x{w}: {int(new[4])} steps, outputs equal "
                  f"bitwise to the baseline's: {same}", flush=True)
            if not same:
                raise AssertionError(f"gn_level {label} level {level}: differs from {tree}")
            compared.append(f"{label} {h}x{w}")
            xi0 = new[0]
    return compared


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_level_stamps needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    if "--baseline" in sys.argv[1:]:
        tree = sys.argv[sys.argv.index("--baseline") + 1]
        compared = level_kernel_against(tree, cs, torch.device("cuda", 0))
        print(json.dumps({"gn_level_bitwise_vs_baseline": compared, "card": cs.card()}))
        return
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.frame import build_frame_with_depth
    from dvo_tpu_torch.models.odometry import _cull_chunk, raw_depth
    from dvo_tpu_torch.models.tracker import level_planes
    from dvo_tpu_torch.ops.cuda import _build
    from dvo_tpu_torch.ops.cuda.gn import _level_step

    dev = torch.device("cuda", 0)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    libs = build_with_stamps(THREADS)
    cfg = DVOConfig.rgbd()
    grays, masks, counts, K = cs.render_rgbd(dev)
    cfg0, K0, (g, m, c) = _cull_chunk(cfg, K.to(dev), grays[:2].to(dev), masks[:2].to(dev),
                                      counts[:2].to(dev))
    depths, sigmas = raw_depth(c, cs.DEPTH_SCALE)
    levels = cfg.pyramid.levels
    ref = build_frame_with_depth(g[0], m[0], depths[0], sigmas[0], K0, levels, 0, 0)
    obj = build_frame_with_depth(g[1], m[1], depths[1], sigmas[1], K0, levels, 0, 1)
    t = dataclasses.replace(cfg0.tracker, max_iterations=STEPS)
    print(f"{cs.card()} | maximum SM clock {mhz:.0f} MHz")
    for threads, lib, level in ((t, lib, lv) for t, lib in zip(THREADS, libs)
                                for lv in range(levels)):
        planes = level_planes(obj.scenes[level], ref.scenes[level])
        Kl = ref.scenes[level].K
        h, w = planes[0].shape
        xi0 = torch.zeros(6, device=dev)
        floats = torch.empty(6 + 2 * STEPS, device=dev)
        ints = torch.empty(STEPS + 1, dtype=torch.int32, device=dev)
        stamps = torch.zeros((STEPS, 6), dtype=torch.int64, device=dev)
        for _ in range(3):   # the last run's stamps are read: warm cache
            code = lib.dvo_gn_level(
                *(p.data_ptr() for p in planes), Kl.data_ptr(), xi0.data_ptr(),
                floats.data_ptr(), floats[6:].data_ptr(), floats[6 + STEPS:].data_ptr(),
                ints.data_ptr(), ints[STEPS:].data_ptr(), stamps.data_ptr(), h, w,
                _level_step(t, level), t.min_depth, t.sigma_clamp[0], t.sigma_clamp[1],
                int(t.compat_weight_b_only), int(level == t.crop_level), t.crop_x[0],
                t.crop_x[1], t.crop_y[0], t.crop_y[1], STEPS, t.damping, 0.0, 0.0,
                _build.stream_handle(dev))
            _build.check(code, "gn_level (stamps)")
            torch.cuda.synchronize()
        if int(ints[STEPS]) != STEPS:
            raise AssertionError(f"level {level}: {int(ints[STEPS])} steps ran, not {STEPS}")
        s = stamps.cpu()
        parts = torch.cat([s[:-1, 1:] - s[:-1, :-1], (s[1:, 0] - s[:-1, 5])[:, None]], dim=1)
        cycles = parts.float().median(dim=0).values.tolist()
        total = (s[1:, 0] - s[:-1, 0]).float().median().item()
        line = ", ".join(f"{name} {cy:.0f}" for name, cy in zip(PARTS, cycles))
        print(f"{threads} threads, level {level} {h}x{w}: cycles per step (median of {STEPS - 1}): {line}; "
              f"step {total:.0f} cycles (at least {total / mhz:.2f} us)", flush=True)


if __name__ == "__main__":
    main()
