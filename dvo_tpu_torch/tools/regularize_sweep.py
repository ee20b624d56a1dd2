"""The depth regulariser's launch candidates on the card, and the shipped
kernel against an earlier tree's.

Run from the repository root on a machine with a CUDA card:

    python3 -m dvo_tpu_torch.tools.regularize_sweep

builds ``csrc/regularize.cu`` once more with ``-DDVO_REGULARIZE_SWEEP`` into
the git-ignored build directory; that build exports
``dvo_regularize_variant``, the kernel at every launch of ``CANDIDATES``
(the kinds of the source's header: ``flat``, ``tile`` and ``walk``; rows of
a block; rows a thread walks).  At each shape of ``SHAPES`` (the mono
path's 120x160, Kinect mono's 106x128, 212x256, and an odd 37x53: partial
warps and blocks), and on the mono path's maps at 120x160 (``mono_maps``:
the state of ``chip_smoke.py``'s kernels phase, run on the CPU), every
candidate is held against ``regularize_plain``
with ``torch.equal`` and timed: device us of one launch (``torch.profiler``,
20 calls, ``chip_smoke.device_profile``) in two turns (the list forwards,
then backwards), beside the launch floor (an empty launch, a copy of the
call's bytes).  The maps come from ``maps()``: smooth depth with noise and
outliers, sigmas across the compatibility gate.

    python3 -m dvo_tpu_torch.tools.regularize_sweep --turns DIR

builds ``DIR/dvo_tpu_torch/csrc/regularize.cu`` (an earlier tree, unpacked
with ``git archive <commit> dvo_tpu_torch/csrc | tar -x -C DIR``), holds
it equal to this tree's ``dvo_regularize`` bit for bit, and times the two in
turns on the same maps: DIR, this tree, this tree, DIR.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = ((120, 160), (106, 128), (212, 256), (37, 53))
# (kind, rows of a block, rows a thread walks), as ops/cuda/regularize.LAUNCH
CANDIDATES = (
    ("flat", 1, 1),
    ("tile", 1, 1), ("tile", 2, 1), ("tile", 4, 1), ("tile", 8, 1),
    ("walk", 1, 1), ("walk", 2, 1), ("walk", 4, 1), ("walk", 8, 1),
    ("walk", 1, 2), ("walk", 2, 2), ("walk", 4, 2),
    ("walk", 1, 4), ("walk", 2, 4), ("walk", 4, 4),
    ("walk", 1, 8), ("walk", 2, 8), ("walk", 4, 8),
)
CALLS = 20          # launches a profile window
SEED = 7


def label(launch) -> str:
    kind, rows, walk = launch
    if kind == "flat":
        return "flat 256"
    return f"{kind} 32x{rows}" + (f" r{walk}" if kind == "walk" else "")


def maps(h: int, w: int, device, seed: int = SEED):
    """(depth, sigma) at h x w: smooth depth of 0.6-2.6 m with noise, 2% of
    outliers up to 7 m (past the 6 m clamp), and sigmas of 0.01-0.5 m, so
    that the compatibility gate passes some neighbours and not others."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 1.6 + 0.6 * np.sin(0.07 * xs + 0.3) * np.cos(0.05 * ys)
    depth += rng.normal(0.0, 0.05, (h, w))
    out = rng.random((h, w)) < 0.02
    depth[out] = rng.uniform(0.3, 7.0, int(out.sum()))
    sigma = 0.01 + 0.49 * rng.random((h, w)) ** 2
    return (torch.from_numpy(depth.astype(np.float32)).to(device),
            torch.from_numpy(sigma.astype(np.float32)).to(device))


def _compile(src_dir: Path, flags, tag: str):
    from dvo_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a file name of its own per tree: dlopen hands back a library already
    # loaded from the same path
    key = hashlib.sha256(str(src_dir.resolve()).encode()).hexdigest()[:12]
    out = _build.BUILD_DIR / f"libdvo_regularize_{tag}_{key}.{os.getpid()}.so"
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-I",
                           str(src_dir), "-o", str(out), str(src_dir / "regularize.cu")],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}) for {src_dir}:\n{done.stderr}")
    lib = ctypes.CDLL(str(out))
    out.unlink()
    return lib


@functools.lru_cache(maxsize=None)
def build_sweep():
    """This tree's ``regularize.cu`` with every candidate instantiated."""
    from dvo_tpu_torch.ops.cuda import _build

    lib = _compile(_build.SOURCE_DIR, ["-DDVO_REGULARIZE_SWEEP"], "sweep")
    lib.dvo_regularize_variant.argtypes = [ctypes.c_int] * 3 + \
        _build._SIGNATURES["dvo_regularize"][0]
    lib.dvo_regularize_variant.restype = ctypes.c_int
    return _build.bind(lib, ["dvo_regularize", "dvo_regularize_kind",
                             "dvo_regularize_block_rows", "dvo_regularize_thread_rows"])


def build_tree(tree):
    """An earlier tree's ``regularize.cu``, from its own sources, bound with
    this tree's signature of ``dvo_regularize``."""
    from dvo_tpu_torch.ops.cuda import _build

    lib = _compile(Path(tree) / "dvo_tpu_torch" / "csrc", [], "tree")
    return _build.bind(lib, ["dvo_regularize"])


def shipped(lib):
    """The launch a library's ``dvo_regularize`` takes, from its C entries."""
    from dvo_tpu_torch.ops.cuda import regularize

    return (regularize.KINDS[lib.dvo_regularize_kind()], lib.dvo_regularize_block_rows(),
            lib.dvo_regularize_thread_rows())


def launcher(lib, launch=None):
    """``fn(depth, sigma, cfg)`` -> the regularised depth through ``lib``'s
    ``dvo_regularize`` (``launch`` None) or ``dvo_regularize_variant``."""
    from dvo_tpu_torch.ops.cuda import _build, regularize

    def fn(depth, sigma, cfg):
        h, w = depth.shape
        out = torch.empty_like(depth)
        args = (depth.data_ptr(), sigma.data_ptr(), out.data_ptr(), h, w,
                cfg.depth_filter.gain_ramp, cfg.max_depth, _build.stream_handle(depth.device))
        if launch is None:
            code = lib.dvo_regularize(*args)
        else:
            kind, rows, walk = launch
            code = lib.dvo_regularize_variant(regularize.KINDS.index(kind), rows, walk, *args)
        _build.check(code, f"regularize ({'shipped' if launch is None else label(launch)})")
        return out

    return fn


def sweep(inputs, cfg, cs, candidates=CANDIDATES, say=print):
    """Every candidate on each (depth, sigma) of ``inputs`` (a dict by shape
    label): held bitwise against ``regularize_plain`` and timed in two turns
    (forwards, then backwards).  ``cs`` is ``chip_smoke`` (its
    ``device_profile``).  Returns one row per shape and candidate."""
    from dvo_tpu_torch.ops.cuda import _build, regularize
    from dvo_tpu_torch.tools import framebuild_floor

    lib = build_sweep()
    ship = shipped(lib)
    if ship != regularize.LAUNCH:
        raise AssertionError(f"regularize: the kernel's launch {ship}, LAUNCH {regularize.LAUNCH}")
    rows = []
    for shape, (depth, sigma) in inputs.items():
        want = regularize.regularize_plain(depth, sigma, cfg)
        fns = {c: launcher(lib, c) for c in candidates}
        for c, fn in fns.items():
            got = fn(depth, sigma, cfg)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                n = int((got != want).sum())
                raise AssertionError(f"regularize {label(c)} at {shape}: {n} pixels differ "
                                     "from regularize_plain")
        times = {c: [] for c in candidates}
        for c in list(candidates) + list(candidates)[::-1]:
            times[c].append(cs.device_profile(lambda: fns[c](depth, sigma, cfg), CALLS,
                                              True)[1])
        nbytes, flops = regularize.work(depth.shape)
        fl = framebuild_floor.floor_us(nbytes, cs.device_profile)
        bound = _build.bound_us(nbytes, flops)[0]
        for c in candidates:
            (gx, gy), (bx, by) = regularize.launch_grid(*depth.shape, c)
            rows.append(dict(shape=shape, launch=label(c), shipped=c == ship, blocks=gx * gy,
                             threads=bx * by, device_us=times[c], bitwise=True,
                             bound_us=bound, launch_floor_us=fl["empty_us"],
                             copy_floor_us=fl["copy_us"]))
        best = min(candidates, key=lambda c: min(times[c]))
        say(f"regularize sweep {shape}: bitwise at every launch; device us (two turns) "
            + ", ".join(f"{label(c)}{' (shipped)' if c == ship else ''} "
                        f"{' / '.join(f'{t:.2f}' for t in times[c])}" for c in candidates)
            + f"; least {label(best)}; empty launch {fl['empty_us']:.2f} us, copy of its "
              f"{fl['copy_bytes']} B {fl['copy_us']:.2f} us, bound {bound:.3f} us")
    return rows


def turns(tree, inputs, cfg, cs, say=print):
    """``tree``'s ``dvo_regularize`` and this tree's, equal bitwise, timed in
    turns (DIR, this, this, DIR) on each input.  Returns {shape: {tree:
    [device us]}}."""
    from dvo_tpu_torch.ops.cuda import _build

    base = launcher(build_tree(tree))
    this = launcher(_build.library())
    out = {}
    for shape, (depth, sigma) in inputs.items():
        a, b = base(depth, sigma, cfg), this(depth, sigma, cfg)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"regularize at {shape}: {tree}'s kernel and this tree's differ")
        times = {"base": [], "this": []}
        for name, fn in (("base", base), ("this", this), ("this", this), ("base", base)):
            times[name].append(cs.device_profile(lambda: fn(depth, sigma, cfg), CALLS, True)[1])
        out[shape] = times
        say(f"regularize {shape}, bitwise equal to {tree}'s; device us in turns: {tree} "
            f"{' / '.join(f'{t:.2f}' for t in times['base'])}, this tree "
            f"{' / '.join(f'{t:.2f}' for t in times['this'])}")
    return out


def mono_maps(cs, dev):
    """The reference's base depth and sigma after ``chip_smoke.py``'s first
    CHUNK mono frames, run on the CPU (its kernels phase's state), on the
    card."""
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.models.odometry import monocular_init, monocular_run

    cfg = DVOConfig.monocular()
    grays, masks, K, _ = cs.render_sequence("cpu")
    gen = torch.Generator().manual_seed(cs.SEED)
    h0, w0 = cs.H >> cfg.pyramid.culls, cs.W >> cfg.pyramid.culls
    noise = torch.randn((h0, w0), generator=gen)
    resets = torch.clamp(0.5 + 1.5 * torch.rand((cs.N_FRAMES, h0, w0), generator=gen), max=4.0)
    n = cs.CHUNK
    state, _ = monocular_run(monocular_init(grays[0], masks[0], K, cfg, device="cpu",
                                            noise=noise),
                             grays[1:1 + n], masks[1:1 + n], K, cfg, resets[:n])
    base = state.ref.base
    return base.depth.to(dev), base.sigma.to(dev)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("regularize_sweep needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from dvo_tpu_torch.config import MapperConfig

    dev = torch.device("cuda", 0)
    card = cs.card()
    print(card, flush=True)
    cfg = MapperConfig()
    inputs = {"mono 120x160": mono_maps(cs, dev),
              **{"x".join(map(str, s)): maps(*s, dev) for s in SHAPES}}
    say = lambda line: print(f"{line} on {card}", flush=True)
    if "--turns" in sys.argv[1:]:
        tree = sys.argv[sys.argv.index("--turns") + 1]
        print(json.dumps({"turns": turns(tree, inputs, cfg, cs, say), "card": card}))
        return
    print(json.dumps({"candidates": sweep(inputs, cfg, cs, say=say), "card": card}))


if __name__ == "__main__":
    main()
