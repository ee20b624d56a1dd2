"""Where one GN step's time goes inside ``csrc/gn_level.cu``, and the level
kernel against an earlier tree's.

Run from the repository root on a machine with a CUDA card:

    python3 -m dvo_tpu_torch.tools.gn_level_stamps

builds ``csrc/gn_level.cu`` once more with ``-DDVO_GN_LEVEL_STAMPS`` into the
git-ignored build directory.  That build stamps ``clock64()`` in the solver
thread (block 0, thread 0) at six points of every step: loop top, pixels
done, block sums done, past the first cluster barrier (a launch of one block
has none: the point is absent), the step solved, past the barrier after it;
and at five marks inside the step (``MARKS``: its start, the solve, the
compose's exponentials, the logarithm, its end).
It also exports ``dvo_gn_level_shaped``, the level kernel at any launch
shape of ``CANDIDATES`` (blocks a launch, threads a block), which the
product's ``dvo_gn_level`` chooses from (h, w) alone.  The tool runs 15
steps that never converge (both thresholds 0) at every candidate and every
level of ``chip_smoke.py``'s mono, RGB-D and Kinect-mono rigs, holds each
run against ``gn_level_plain`` at ``chip_smoke.py``'s tolerances, and prints
per candidate and level the median SM cycles of each part of a step and of
the whole step, beside the card's maximum SM clock (a launch this short does
not hold the clock that ``nvidia-smi`` samples, so the cycles are not
converted), and the shape ``gn_level.launch_shape`` takes there.

``build_shapes`` builds the same candidates without stamps, and
``shaped_levels`` puts ``dvo_gn_level_shaped`` at another shape in place of
the product's entry (``chip_smoke.py`` runs the monocular path so, at
``other_shape`` on every level).

    python3 -m dvo_tpu_torch.tools.gn_level_stamps --baseline DIR

builds ``DIR/dvo_tpu_torch/csrc/gn_level.cu`` (an earlier tree, unpacked with
``git archive <commit> dvo_tpu_torch/csrc | tar -x -C DIR``) and holds this
tree's level kernel against it at every level of the mono and RGB-D rigs'
first two frames: "bitwise" where every output is equal, else the largest
|d xi| and |d statistics| and whether the iterations and valid counts are
equal.

    python3 -m dvo_tpu_torch.tools.gn_level_stamps --turns DIR

measures DIR's kernels (``gn_level.cu`` and ``gn.cu``'s step kernel, built
from DIR's sources and put in place of this tree's through the same C
entries) and this tree's in turns: DIR, this tree, this tree, DIR.  Each
turn reads the cycles of each part of a step at every level (each tree's
own stamps build, the shape each tree's ``dvo_gn_level`` takes); the
graphed mono and RGB-D paths' ms/frame, device-busy us a frame and the
level kernel's device us a frame by level (``chip_smoke.gn_level_per_frame``)
with the steps a level; and the step kernel's device us.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

STEPS = 15
POINTS = ("loop top", "pixels done", "block sums done", "past barrier 1", "step solved",
          "past barrier 2")
# (blocks a launch, threads a block) the stamps build instantiates
CANDIDATES = ((1, 256), (1, 512), (1, 1024), (8, 256), (8, 512), (8, 1024), (16, 256),
              (16, 512), (16, 1024))
TIMED_RUNS = 3      # host-clock runs of a graphed path a turn (the median is kept)


def _nvcc(args, what):
    from dvo_tpu_torch.ops.cuda import _build

    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *args], capture_output=True,
                          text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}) for {what}:\n{done.stderr}")


def _load(out, names):
    from dvo_tpu_torch.ops.cuda import _build

    lib = ctypes.CDLL(str(out))
    out.unlink()
    for name in names:
        if not hasattr(lib, name):
            continue
        if name == "dvo_gn_level_shaped":
            lib.dvo_gn_level_shaped.argtypes = [ctypes.c_int, ctypes.c_int] + \
                _build._SIGNATURES["dvo_gn_level"][0]
            lib.dvo_gn_level_shaped.restype = ctypes.c_int
        else:
            _build.bind(lib, [name])
    return lib


def build_stamps(csrc: Path, tag: str):
    """``csrc``'s ``gn_level.cu`` built with its clock stamps."""
    from dvo_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libdvo_gn_level_stamps_{tag}.{os.getpid()}.so"
    _nvcc(["-DDVO_GN_LEVEL_STAMPS", "-shared", "-I", str(csrc), "-o", str(out),
           str(csrc / "gn_level.cu")], f"{csrc} with stamps")
    return _load(out, ["dvo_gn_level", "dvo_gn_level_shaped"])


def build_shapes(csrc: Path = None):
    """``csrc``'s ``gn_level.cu`` (default: this tree's) built with
    ``-DDVO_GN_LEVEL_SHAPES``: ``dvo_gn_level`` and ``dvo_gn_level_shaped``
    at every shape of ``CANDIDATES``, without stamps."""
    from dvo_tpu_torch.ops.cuda import _build

    csrc = _build.SOURCE_DIR if csrc is None else Path(csrc)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libdvo_gn_level_shapes.{os.getpid()}.so"
    _nvcc(["-DDVO_GN_LEVEL_SHAPES", "-shared", "-I", str(csrc), "-o", str(out),
           str(csrc / "gn_level.cu")], f"{csrc} with every shape")
    return _load(out, ["dvo_gn_level", "dvo_gn_level_shaped"])


def other_shape(h: int, w: int):
    """A launch shape other than ``gn_level.launch_shape(h, w)``, at every
    level: the other cluster size (8 <-> 16 blocks), the same threads."""
    from dvo_tpu_torch.ops.cuda import gn_level

    blocks, threads = gn_level.launch_shape(h, w)
    return 24 - blocks, threads


def shaped_levels(lib, shape_of):
    """The level wrapper launches ``lib.dvo_gn_level_shaped`` at
    ``shape_of(h, w)`` in place of ``dvo_gn_level`` (this tree's other
    entries unchanged)."""
    def level(*args):   # dvo_gn_level's arguments: 17 pointers, then h, w
        return lib.dvo_gn_level_shaped(*shape_of(args[17], args[18]), *args)

    return swapped(dvo_gn_level=level)


_TREES = itertools.count()


def build_tree(tree):
    """An earlier tree's ``gn.cu`` and ``gn_level.cu``, from its own sources,
    bound with this tree's signatures."""
    from dvo_tpu_torch.ops.cuda import _build

    src = Path(tree) / "dvo_tpu_torch" / "csrc"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of its own per tree: dlopen hands back a library already loaded
    # under the same path, whatever the file now holds
    tag = f"{_build.BUILD_DIR}/libdvo_tree_{next(_TREES)}.{os.getpid()}"
    objs = [Path(f"{tag}.{name}.o") for name in ("gn", "gn_level")]
    procs = [subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-c",
                               str(src / f"{name}.cu"), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, obj in zip(("gn", "gn_level"), objs)]
    for proc in procs:
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n{err}")
    out = Path(f"{tag}.so")
    done = subprocess.run(_build.link_command(objs, out), capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if done.returncode != 0:
        raise RuntimeError(f"link failed for {src}:\n{done.stderr}")
    return _load(out, ["dvo_gn_level", "dvo_gn_step", "dvo_gn_num_blocks", "dvo_gn_terms"])


@contextlib.contextmanager
def swapped(**entries):
    """The wrappers call ``entries`` (C entry name -> function) in place of
    this tree's, and this tree's other entries."""
    from dvo_tpu_torch.ops.cuda import _build

    real = _build.library()

    class Swapped:
        def __getattr__(self, name):
            return entries[name] if name in entries else getattr(real, name)

    saved = _build.library
    _build.library = lambda: Swapped()
    try:
        yield
    finally:
        _build.library = saved


def kernels_of(lib):
    """The wrappers launch ``lib``'s ``dvo_gn_level`` and ``dvo_gn_step``
    (and this tree's other entries); ``lib`` None: this tree's own."""
    if lib is None:
        return contextlib.nullcontext()
    return swapped(dvo_gn_level=lib.dvo_gn_level, dvo_gn_step=lib.dvo_gn_step)


def level_args(planes, K, xi0, level, t, n, floats, ints, stamps):
    """``dvo_gn_level``'s arguments after the shape (the C ABI's order)."""
    from dvo_tpu_torch.ops.cuda import _build
    from dvo_tpu_torch.ops.cuda.gn import _level_step

    h, w = planes[0].shape
    return (*(p.data_ptr() for p in planes), K.data_ptr(), xi0.data_ptr(), floats.data_ptr(),
            floats[6:].data_ptr(), floats[6 + n:].data_ptr(), ints.data_ptr(),
            ints[n:].data_ptr(), None if stamps is None else stamps.data_ptr(), h, w,
            _level_step(t, level), t.min_depth, t.sigma_clamp[0], t.sigma_clamp[1],
            int(t.compat_weight_b_only), int(level == t.crop_level), t.crop_x[0], t.crop_x[1],
            t.crop_y[0], t.crop_y[1], n, t.damping, t.min_update_norm, t.min_residual,
            _build.stream_handle(planes[0].device))


def rig_levels(cs, dev):
    """(rig, level, planes, K, tracker config) at every level of the mono,
    RGB-D and Kinect-mono rigs: each rig's first frame as the reference,
    its second as the object."""
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.frame import build_frame_with_depth, build_tracking_frame
    from dvo_tpu_torch.models.odometry import (
        _cull_chunk,
        monocular_init,
        monocular_init_with_depth,
        raw_depth,
    )
    from dvo_tpu_torch.models.tracker import level_planes

    out = []
    cfg = DVOConfig.monocular()
    grays, masks, K, _ = cs.render_sequence(dev)
    state = monocular_init(grays[0], masks[0], K, cfg, device=dev)
    cfg0, K0, (g, m) = _cull_chunk(cfg, K, grays[1], masks[1])
    frame = build_tracking_frame(g, m, K0, cfg.pyramid.levels, 0, 1)
    pairs = [("mono", frame, state.ref, cfg0.tracker)]
    cfg_r = DVOConfig.rgbd()
    r_grays, r_masks, r_counts, r_K = cs.render_rgbd(dev)
    cfg_rc, K_r, (g, m, c) = _cull_chunk(cfg_r, r_K.to(dev), *(
        x[:2].to(dev) for x in (r_grays, r_masks, r_counts)))
    d, sg = raw_depth(c, cs.DEPTH_SCALE)
    levels = cfg_r.pyramid.levels
    ref = build_frame_with_depth(g[0], m[0], d[0], sg[0], K_r, levels, 0, 0)
    obj = build_frame_with_depth(g[1], m[1], d[1], sg[1], K_r, levels, 0, 1)
    pairs.append(("rgbd", obj, ref, cfg_rc.tracker))
    d0, s0 = raw_depth(r_counts[0].to(dev), cs.DEPTH_SCALE)
    kin = monocular_init_with_depth(r_grays[0].to(dev), r_masks[0].to(dev), d0, s0,
                                    r_K.to(dev), cfg, device=dev)
    cfg_k, K_k, (g, m) = _cull_chunk(cfg, r_K.to(dev), r_grays[1].to(dev), r_masks[1].to(dev))
    pairs.append(("kinect_mono", build_tracking_frame(g, m, K_k, cfg.pyramid.levels, 0, 1),
                  kin.ref, cfg_k.tracker))
    for rig, obj, ref, t in pairs:
        for level in range(len(ref.scenes)):
            out.append((rig, level, level_planes(obj.scenes[level], ref.scenes[level]),
                        ref.scenes[level].K, t))
    return out


MARKS = ("step start", "solved", "exponentials", "logarithm", "step end")


def stamp_parts(stamps):
    """(the median cycles of each part between the points stamped, by name;
    the median cycles of a whole step) from a stamps buffer: (STEPS, 6)
    points, a point left at 0 being absent, then (STEPS, 5) marks inside the
    step where the build has them."""
    s = stamps[:STEPS * len(POINTS)].reshape(STEPS, len(POINTS)).cpu().to(torch.float64)
    marks = stamps[STEPS * len(POINTS):].reshape(STEPS, len(MARKS)).cpu().to(torch.float64)
    present = [k for k in range(len(POINTS)) if bool((s[:, k] != 0).all())]
    parts = {}
    for a, b in zip(present, present[1:]):
        parts[f"{POINTS[a]} -> {POINTS[b]}"] = s[:-1, b].sub(s[:-1, a]).median().item()
    parts[f"{POINTS[present[-1]]} -> next loop top"] = \
        s[1:, 0].sub(s[:-1, present[-1]]).median().item()
    if bool((marks != 0).all()):
        for k in range(1, len(MARKS)):
            parts[f"step: {MARKS[k - 1]} -> {MARKS[k]}"] = \
                marks[:, k].sub(marks[:, k - 1]).median().item()
    return parts, s[1:, 0].sub(s[:-1, 0]).median().item()


def stamped_run(fn, planes, K, level, t, dev):
    """Three runs of 15 never-converging steps (the last one's stamps read:
    warm caches); returns (outputs, stamps)."""
    from dvo_tpu_torch.ops.cuda import _build

    t = dataclasses.replace(t, max_iterations=STEPS, min_update_norm=0.0, min_residual=0.0)
    xi0 = torch.zeros(6, device=dev)
    floats = torch.empty(6 + 2 * STEPS, device=dev)
    ints = torch.empty(STEPS + 1, dtype=torch.int32, device=dev)
    stamps = torch.zeros(STEPS * (len(POINTS) + len(MARKS)), dtype=torch.int64, device=dev)
    for _ in range(3):
        _build.check(fn(*level_args(planes, K, xi0, level, t, STEPS, floats, ints, stamps)),
                     "gn_level (stamps)")
        torch.cuda.synchronize()
    if int(ints[STEPS]) != STEPS:
        raise AssertionError(f"level {level}: {int(ints[STEPS])} steps ran, not {STEPS}")
    out = (floats[:6], floats[6:6 + STEPS], floats[6 + STEPS:], ints[:STEPS], ints[STEPS])
    return out, stamps, t


def check_against_plain(cs, out, planes, K, level, t):
    """A stamped run's outputs against ``gn_level_plain`` at chip_smoke.py's
    tolerances.  Returns |d xi|."""
    from dvo_tpu_torch.ops.cuda import gn_level

    want = gn_level.gn_level_plain(planes, K, torch.zeros(6, device=K.device), level, t)
    dxi = (out[0] - want[0]).abs().max().item()
    rel = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)
              for a, b in zip(out[1:3], want[1:3]))
    if not (dxi <= cs.GN_LEVEL_XI_TOL and rel <= cs.GN_LEVEL_STAT_TOL
            and torch.equal(out[3], want[3]) and int(out[4]) == int(want[4])):
        raise AssertionError(f"level {level}: |d xi| {dxi:.3g}, statistics {rel:.3g}, counts "
                             f"{out[3].tolist()} vs {want[3].tolist()}")
    return dxi


def sweep(cs, dev, mhz):
    """Every candidate shape at every rig level; one line each."""
    from dvo_tpu_torch.ops.cuda import _build, gn_level

    lib = build_stamps(_build.SOURCE_DIR, "sweep")
    rows = []
    for rig, level, planes, K, t in rig_levels(cs, dev):
        h, w = planes[0].shape
        chosen = gn_level.launch_shape(h, w)
        for blocks, threads in CANDIDATES:
            fn = lambda *a: lib.dvo_gn_level_shaped(blocks, threads, *a)
            try:
                out, stamps, t15 = stamped_run(fn, planes, K, level, t, dev)
            except RuntimeError as err:   # a shape the card refuses is no candidate
                print(f"{rig} level {level} {h}x{w}, {blocks} x {threads}: {err}", flush=True)
                rows.append(dict(rig=rig, level=level, shape=f"{h}x{w}", blocks=blocks,
                                 threads=threads, refused=str(err)))
                continue
            dxi = check_against_plain(cs, out, planes, K, level, t15)
            parts, step = stamp_parts(stamps)
            rows.append(dict(rig=rig, level=level, shape=f"{h}x{w}", blocks=blocks,
                             threads=threads, chosen=(blocks, threads) == chosen,
                             step_cycles=step, parts=parts, dxi=dxi))
            print(f"{rig} level {level} {h}x{w}, {blocks} x {threads}"
                  f"{' (chosen)' if rows[-1]['chosen'] else ''}: step {step:.0f} cycles "
                  f"(at least {step / mhz:.2f} us); "
                  + ", ".join(f"{k} {v:.0f}" for k, v in parts.items())
                  + f"; |d xi| vs plain {dxi:.3g}", flush=True)
    return rows


def level_kernel_against(tree, cs, dev):
    """This tree's level kernel against ``tree``'s at every level of the
    mono and RGB-D rigs, each level from the baseline's xi of the level
    before.  Returns {level: "bitwise" or the differences}."""
    from dvo_tpu_torch.ops.cuda import _build, gn_level

    base = build_tree(tree)
    report = {}
    xi0 = {}
    for rig, level, planes, K, t in rig_levels(cs, dev):
        if rig == "kinect_mono":
            continue
        start = xi0.get(rig, torch.zeros(6, device=dev))
        new = gn_level.gn_level(planes, K, start, level, t)
        n = t.max_iterations
        floats = torch.empty(6 + 2 * n, device=dev)
        ints = torch.empty(n + 1, dtype=torch.int32, device=dev)
        _build.check(base.dvo_gn_level(*level_args(planes, K, start, level, t, n, floats, ints,
                                                   None)), "gn_level (baseline)")
        old = (floats[:6], floats[6:6 + n], floats[6 + n:], ints[:n], ints[n])
        h, w = planes[0].shape
        key = f"{rig} level {level} {h}x{w}"
        if all(torch.equal(a, b) for a, b in zip(new, old)):
            report[key] = "bitwise"
        else:
            report[key] = dict(
                dxi=(new[0] - old[0]).abs().max().item(),
                dstats=max((a - b).abs().max().item() for a, b in zip(new[1:3], old[1:3])),
                iterations_equal=int(new[4]) == int(old[4]),
                counts_equal=torch.equal(new[3], old[3]))
        print(f"gn_level {key}: {int(old[4])} steps (baseline), {int(new[4])} (this tree): "
              f"{report[key]}", flush=True)
        xi0[rig] = old[0]
    return report


def paths(cs, dev):
    """The graphed mono and RGB-D runs of chip_smoke.py's rigs: {name: (make,
    frames, levels, finest (h, w), max_iterations)}; ``make()`` makes a fresh
    first state, captures its driver with an untimed chunk, and returns
    ``run()``, which replays it over the path's frames."""
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.odometry import monocular_init, monocular_run, raw_depth, \
        rgbd_init, rgbd_run_raw

    cfg = DVOConfig.monocular()
    grays, masks, K, _ = cs.render_sequence(dev)
    gen = torch.Generator().manual_seed(cs.SEED)
    h0, w0 = cs.H >> cfg.pyramid.culls, cs.W >> cfg.pyramid.culls
    noise = torch.randn((h0, w0), generator=gen)
    resets = torch.clamp(0.5 + 1.5 * torch.rand((cs.N_FRAMES, h0, w0), generator=gen),
                         max=4.0).to(dev)
    n = cs.CHUNK

    def mono():
        start = monocular_init(grays[0], masks[0], K, cfg, device=dev, noise=noise)
        monocular_run(start, grays[1:1 + n], masks[1:1 + n], K, cfg, resets[:n])
        return lambda: [monocular_run(start, grays[1:1 + n], masks[1:1 + n], K, cfg,
                                      resets[:n])[1]]

    cfg_r = DVOConfig.rgbd()
    r_grays, r_masks, r_counts, r_K = cs.render_rgbd(dev)
    m = cs.RGBD_FRAMES

    def rgbd():
        d0, s0 = raw_depth(r_counts[0].to(dev), cs.DEPTH_SCALE)
        start = rgbd_init(r_grays[0], r_masks[0], d0, s0, r_K, cfg_r, device=dev)
        run = lambda: [rgbd_run_raw(start, r_grays[1:1 + m], r_masks[1:1 + m],
                                    r_counts[1:1 + m], r_K, cfg_r,
                                    depth_scale=cs.DEPTH_SCALE)[1]]
        run()
        return run

    c = cfg_r.pyramid.culls
    return dict(mono=(mono, n, cfg.pyramid.levels, (h0, w0), cfg.tracker.max_iterations),
                rgbd=(rgbd, m, cfg_r.pyramid.levels, (cs.RH >> c, cs.RW >> c),
                      cfg_r.tracker.max_iterations))


def step_kernel_us(cs, dev):
    """The step kernel's device us for one step (``device_profile``)."""
    from dvo_tpu_torch.config import TrackerConfig
    from dvo_tpu_torch.ops.cuda import gn, gn_level

    cfg = TrackerConfig()
    n = cfg.max_iterations
    xi0 = torch.tensor([0.003, -0.001, 0.002, 0.0005, -0.001, 0.0], device=dev)
    A = torch.eye(6, device=dev) * 50.0 + 1.0
    sums = gn.pack_sums(A, torch.ones(6, device=dev), torch.tensor(2.0, device=dev),
                        torch.tensor(900, dtype=torch.int32, device=dev))
    state = torch.zeros(gn_level.STATE, device=dev)
    stats = torch.zeros(2 * n, device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    step = gn_level.step_launcher(sums, xi0, state, stats[:n], stats[n:], counts, cfg)
    step(gn_level.SEED)
    return cs.device_profile(lambda: step(1), 20, True)[1]


def turn(cs, dev, label, lib, stamps_lib, levels, runs):
    """One turn: this tree's kernels (``lib`` None) or another tree's."""
    out = dict(tree=label, stamps={}, paths={})
    for rig, level, planes, K, t in levels:
        h, w = planes[0].shape
        _, stamps, _ = stamped_run(stamps_lib.dvo_gn_level, planes, K, level, t, dev)
        parts, step = stamp_parts(stamps)
        out["stamps"][f"{rig} {h}x{w}"] = dict(step_cycles=step, parts=parts)
    with kernels_of(lib):
        for name, (make, frames, n_levels, base, max_it) in runs.items():
            run = make()
            secs = []
            for _ in range(TIMED_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            per = cs.gn_level_per_frame(
                run, frames, n_levels, torch.cat([r.tracking.iterations for r in res]).cpu(),
                torch.cat([r.tracking.valid_counts for r in res]).cpu(),
                cs.level_shapes(*base, n_levels), max_it)
            per["ms_per_frame"] = 1e3 * statistics.median(secs) / frames
            out["paths"][name] = per
        out["step_kernel_us"] = step_kernel_us(cs, dev)
    print(f"turn {label}: " + json.dumps(cs.plain_json(out)), flush=True)
    return out


def turns(tree, cs, dev):
    """DIR, this tree, this tree, DIR."""
    from dvo_tpu_torch.ops.cuda import _build

    base = build_tree(tree)
    stamps = dict(base=build_stamps(Path(tree) / "dvo_tpu_torch" / "csrc", "base"),
                  this=build_stamps(_build.SOURCE_DIR, "this"))
    levels = [lv for lv in rig_levels(cs, dev) if lv[0] != "kinect_mono"]
    runs = paths(cs, dev)
    order = (("base", base), ("this", None), ("this", None), ("base", base))
    return [turn(cs, dev, label, lib, stamps[label], levels, runs) for label, lib in order]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_level_stamps needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    if "--baseline" in sys.argv[1:]:
        tree = sys.argv[sys.argv.index("--baseline") + 1]
        report = level_kernel_against(tree, cs, dev)
        print(json.dumps({"gn_level_vs_baseline": report, "card": cs.card()}))
        return
    if "--turns" in sys.argv[1:]:
        tree = sys.argv[sys.argv.index("--turns") + 1]
        print(json.dumps(cs.plain_json({"turns": turns(tree, cs, dev), "card": cs.card()})))
        return
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    print(f"maximum SM clock {mhz:.0f} MHz", flush=True)
    rows = sweep(cs, dev, mhz)
    print(json.dumps(cs.plain_json({"candidates": rows, "card": cs.card(), "sm_mhz": mhz})))


if __name__ == "__main__":
    main()
