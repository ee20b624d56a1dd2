"""How ``csrc/epipolar.cu`` uses the card: lanes per pixel, pixels per block.

Run from the repository root on a machine with a CUDA card:

    python3 -m dvo_tpu_torch.tools.epipolar_sweep [--baseline DIR] [--stamps]

Builds ``csrc/epipolar.cu`` once per variant (``-DDVO_EPI_LANES``,
``-DDVO_EPI_PIXELS``, ``-DDVO_EPI_THREADS``; one ``nvcc`` each, all at once,
with ``-Xptxas -v``) into the git-ignored build directory, and on the state a monocular run of ``chip_smoke.py``'s frames
leaves (120x160, the 8-slot ring full) holds every variant's fused entry
against the plain version (it must equal the library's own build bit for
bit) and times it with ``torch.profiler``: device microseconds of one
launch, variants in turns (the list forwards, then backwards).  Prints one
line per variant, beside the card's name and power limit.

``--baseline DIR`` names an unpacked tree of an earlier commit whose
``csrc/epipolar.cu`` has the one-thread-per-pixel kernel (entry
``dvo_epipolar`` writing per-block partial counts): it is built from there
and timed in the same turns on the same 24 field planes, the ``torch.sum``
of its partials included.  ``--stamps`` builds the library's own constants
once more with ``-DDVO_EPI_STAMPS=1`` and prints where a launch's time goes:
the nanosecond timer at the kernel's phase boundaries, per block.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

LANES = (4, 8, 16, 32)
# (lanes, pixels a block owns, threads of a block); the first len(LANES) are
# the library's own constants at each lane width.
VARIANTS = tuple((lanes, 64, 512) for lanes in LANES) + (
    (4, 32, 256), (8, 32, 256), (16, 32, 256), (32, 32, 256), (8, 64, 256), (16, 64, 256),
    (16, 32, 128), (16, 32, 512), (16, 96, 512), (8, 96, 512), (16, 128, 512), (16, 64, 1024),
    (16, 128, 1024), (32, 128, 1024), (16, 160, 1024),
)


def label(variant) -> str:
    lanes, pixels, threads = variant
    return f"lanes {lanes}, {pixels} px / block of {threads}"


def build_variants(variants, verbose: bool = False):
    """One library per variant of ``csrc/epipolar.cu``, every ``nvcc`` at
    once; returns (libraries with both epipolar entries bound, ptxas
    output per variant)."""
    from dvo_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [_build.BUILD_DIR / f"libdvo_epipolar_{'_'.join(map(str, v))}.{os.getpid()}.so"
            for v in variants]
    procs = [subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", f"-DDVO_EPI_LANES={lanes}",
         f"-DDVO_EPI_PIXELS={pixels}", f"-DDVO_EPI_THREADS={threads}", "-shared", "-I",
         str(_build.SOURCE_DIR), "-o", str(out), str(_build.SOURCE_DIR / "epipolar.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for (lanes, pixels, threads), out in zip(variants, outs)]
    libs, logs = [], []
    for proc, out, variant in zip(procs, outs, variants):
        stderr = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {label(variant)}:\n{stderr}")
        lib = _build.bind(ctypes.CDLL(str(out)),
                          [n for n in _build._SIGNATURES if n.startswith("dvo_epipolar")])
        out.unlink()
        if (lib.dvo_epipolar_lanes(), lib.dvo_epipolar_pixels(),
                lib.dvo_epipolar_threads()) != tuple(variant):
            raise AssertionError(f"{label(variant)}: the library reports other constants")
        libs.append(lib)
        logs.append(stderr)
        if verbose:
            print(f"--- ptxas, {label(variant)}\n{stderr.strip()}", flush=True)
    return libs, logs


def resources(log: str) -> str:
    """'registers/shared bytes' of the fused kernel from ptxas -v output."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "epipolar_kernel" in line and "ILb1" in line:
            for used in lines[i:i + 4]:
                if "Used" in used:
                    return used.split("Used", 1)[1].strip()
    return "?"


def build_baseline(tree: Path):
    """The one-thread-per-pixel kernel of an earlier commit, from its own
    sources, with its own interface."""
    from dvo_tpu_torch.ops.cuda import _build

    src = tree / "dvo_tpu_torch" / "csrc"
    out = _build.BUILD_DIR / f"libdvo_epipolar_baseline.{os.getpid()}.so"
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(src), "-o",
                           str(out), str(src / "epipolar.cu")], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}) for the baseline:\n{done.stderr}")
    lib = ctypes.CDLL(str(out))
    out.unlink()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dvo_epipolar_num_blocks.argtypes, lib.dvo_epipolar_num_blocks.restype = [I], I
    lib.dvo_epipolar.argtypes = [P] * 9 + [I] * 4 + [F] * 10 + [P]
    lib.dvo_epipolar.restype = I
    return lib


def baseline_call(lib, fields, ring, cfg):
    """One update with the earlier kernel: its launch and the ``torch.sum``
    of its per-block counts.  Returns (depth, sigma, age, stats)."""
    from dvo_tpu_torch.ops.cuda import _build, epipolar

    _, h, w = fields.shape
    dev = fields.device
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    sigma = torch.empty_like(depth)
    age = torch.empty((h, w), dtype=torch.int32, device=dev)
    partials = torch.empty((lib.dvo_epipolar_num_blocks(h * w), 3), dtype=torch.int32,
                           device=dev)
    code = lib.dvo_epipolar(fields.data_ptr(), *(t.data_ptr() for t in ring), depth.data_ptr(),
                            sigma.data_ptr(), age.data_ptr(), partials.data_ptr(), h, w,
                            ring[0].shape[0], cfg.max_steps + 2, *epipolar._scalars(cfg),
                            _build.stream_handle(dev))
    _build.check(code, "epipolar (baseline)")
    return depth, sigma, age, torch.sum(partials, dim=0, dtype=torch.int32)


STAMPS = ("prepare", "list", "march", "finish")


def stamps(args, say=print):
    """Where a launch's time goes: the library's own constants built with
    ``-DDVO_EPI_STAMPS=1``; thread 0 of every block stamps the nanosecond
    timer at the phase boundaries of the fused kernel.  Prints per phase the
    median and the maximum over the blocks, and the span from the first
    block's start to the last block's end."""
    import chip_smoke as cs
    from dvo_tpu_torch.models import mapper
    from dvo_tpu_torch.ops.cuda import _build, epipolar

    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset, cfg = args
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libdvo_epipolar_stamps.{os.getpid()}.so"
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DDVO_EPI_STAMPS=1", "-shared",
                           "-I", str(_build.SOURCE_DIR), "-o", str(out),
                           str(_build.SOURCE_DIR / "epipolar.cu")], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}):\n{done.stderr}")
    lib = _build.bind(ctypes.CDLL(str(out)),
                      [n for n in _build._SIGNATURES if n.startswith("dvo_epipolar")])
    out.unlink()
    lib.dvo_epipolar_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dvo_epipolar_stamps.restype = ctypes.c_int
    table = mapper.pose_table(obj.K, obj_xi, rel_xi, hist)
    blocks = -(-depth.numel() // lib.dvo_epipolar_pixels())
    for _ in range(5):      # the last launch's stamps are read: warm caches
        with cs.patched(_build, "library", lambda: lib):
            epipolar.epipolar_fused(obj.gray, obj.mask, depth, sigma, age, reset, table,
                                    hist.gray, hist.gx, hist.gy, hist.gmask, hist.head,
                                    hist.count, cfg)
        torch.cuda.synchronize()
    t = torch.empty((blocks, 5), dtype=torch.int64)
    _build.check(lib.dvo_epipolar_stamps(t.data_ptr(), blocks), "epipolar (stamps)")
    parts = (t[:, 1:] - t[:, :-1]).double()
    line = ", ".join(f"{name} {parts[:, k].median().item() / 1e3:.2f} (max "
                     f"{parts[:, k].max().item() / 1e3:.2f})" for k, name in enumerate(STAMPS))
    say(f"stamps, lanes {lib.dvo_epipolar_lanes()}, {lib.dvo_epipolar_pixels()} px / block of "
        f"{lib.dvo_epipolar_threads()}, {blocks} blocks: us per phase, median over the blocks "
        f"(maximum): {line}; a block {(t[:, 4] - t[:, 0]).double().median().item() / 1e3:.2f} "
        f"(max {(t[:, 4] - t[:, 0]).max().item() / 1e3:.2f}); blocks start within "
        f"{(t[:, 0].max() - t[:, 0].min()).item() / 1e3:.2f} us; first start to last end "
        f"{(t[:, 4].max() - t[:, 0].min()).item() / 1e3:.2f} us")


def sweep(args, variants=VARIANTS, baseline=None, verbose=False, say=print):
    """Build ``variants``, hold each against the plain version on the
    ``models.mapper.depth_update`` arguments ``args`` and time each in turns.
    Returns one dict per variant (and one for the baseline)."""
    import chip_smoke as cs
    from dvo_tpu_torch.models import mapper
    from dvo_tpu_torch.ops.cuda import _build, epipolar

    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset, cfg = args
    ring = (hist.gray, hist.gx, hist.gy, hist.gmask)
    fields, aged_out = mapper.epipolar_fields(*args)
    want = epipolar.epipolar_update_plain(fields, *ring, cfg)
    want_stats = want[3].tolist() + [int(aged_out)]
    table = mapper.pose_table(obj.K, obj_xi, rel_xi, hist)
    own = mapper.depth_update(*args)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(own[:3], want[:3]))
    say(f"{depth.shape[0]}x{depth.shape[1]}, {int(hist.count)} of {hist.capacity} keyframes: "
        f"{int((fields[epipolar.F_BASE_OK] > 0.5).sum())} observing pixels, "
        f"{int(epipolar.marched_samples(fields, cfg))} samples marched, counts {want_stats}; "
        f"the library's own build bit-identical to the plain version: {identical}")
    libs, logs = build_variants(variants, verbose)

    def fused(lib):
        with cs.patched(_build, "library", lambda: lib):
            return epipolar.epipolar_fused(obj.gray, obj.mask, depth, sigma, age, reset, table,
                                           *ring, hist.head, hist.count, cfg)

    def fields_entry(lib):
        with cs.patched(_build, "library", lambda: lib):
            return epipolar.epipolar_update(fields, *ring, cfg)

    rows = []
    for variant, lib, log in zip(variants, libs, logs):
        got = fused(lib)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got[:3], own[:3])) or \
                got[3].tolist() != [int(getattr(own[3], k)) for k in
                                    ("observed", "accepted", "rejected", "aged_out")]:
            raise AssertionError(f"{label(variant)}: differs from the library's own build")
        cs.compare_maps(f"{label(variant)} depth", got[0], want[0])
        rows.append(dict(variant=label(variant), lanes=variant[0], pixels=variant[1],
                         threads=variant[2], resources=resources(log),
                         stats=got[3].tolist(), fused_us=[], fields_us=[]))
    turns = list(zip(rows, libs))
    base_row = None
    if baseline is not None:
        base_lib = build_baseline(Path(baseline))
        got = baseline_call(base_lib, fields, ring, cfg)
        torch.cuda.synchronize()
        cs.compare_maps("baseline depth", got[0], want[0])
        base_row = dict(variant="one thread per pixel (earlier commit)", fields_us=[],
                        launches=None)
    for order in (turns, turns[::-1]):
        if base_row is not None:
            ops, us = cs.device_profile(lambda: baseline_call(base_lib, fields, ring, cfg), 20,
                                        True)
            base_row["fields_us"].append(us)
            base_row["launches"] = ops
        for row, lib in order:
            ops, us = cs.device_profile(lambda: fused(lib), 20, True)
            row["fused_us"].append(us)
            row["launches"] = ops
            row["fields_us"].append(cs.device_profile(lambda: fields_entry(lib), 20, True)[1])
    for row in rows + ([base_row] if base_row else []):
        fmt = lambda xs: " / ".join(f"{x:.2f}" for x in xs)
        say(f"{row['variant']}: " + (f"fused {fmt(row['fused_us'])} us, " if "fused_us" in row
                                     else "")
            + f"fields entry {fmt(row['fields_us'])} us (device, {row['launches']:g} ops a call, "
              f"the two turns)" + (f"; {row['resources']}" if "resources" in row else ""))
    return rows + ([base_row] if base_row else [])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="unpacked tree of an earlier commit to time beside")
    parser.add_argument("--lanes-only", action="store_true", help="only the four lane widths")
    parser.add_argument("--ptxas", action="store_true", help="print ptxas -v of every variant")
    parser.add_argument("--stamps", action="store_true",
                        help="also time the phases inside the fused kernel")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("epipolar_sweep needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.odometry import _cull_chunk, monocular_init, monocular_run

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DVOConfig.monocular()
    grays, masks, K, _ = cs.render_sequence(dev)
    state = monocular_init(grays[0], masks[0], K, cfg)
    state, _ = monocular_run(state, grays[1:1 + cs.CHUNK], masks[1:1 + cs.CHUNK], K, cfg)
    nxt = 1 + cs.CHUNK
    cfg0, K0, (gray, mask) = _cull_chunk(cfg, K, grays[nxt], masks[nxt])
    args, _ = cs.depth_update_args(state, gray, mask, K0, cfg0)
    print(cs.card(), flush=True)
    if opts.stamps:
        stamps(args)
    sweep(args, VARIANTS[:len(LANES)] if opts.lanes_only else VARIANTS, opts.baseline,
          verbose=opts.ptxas)


if __name__ == "__main__":
    main()
