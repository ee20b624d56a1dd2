"""What a launch of ``csrc/framebuild.cu`` costs against the card's floor,
and the kernels against an earlier commit's.

Run from the repository root on a machine with a CUDA card:

    python3 -m dvo_tpu_torch.tools.framebuild_floor [--baseline DIR]

The floor (``csrc/floor.cu``, through the same ctypes route as every
kernel): an empty kernel, and a copy kernel that moves a kernel's bytes
(half read, half written), each timed with ``torch.profiler`` (device
microseconds of one launch).  On the frames ``chip_smoke.py`` renders
(120x160 x 3 levels, the monocular path; 212x256 x 4, the RGB-D path) it
times the frame build and the regularize-and-cull launch beside them.
``--baseline DIR`` (repeatable) names an unpacked tree of an earlier commit
or another design whose ``csrc/framebuild.cu`` has the same two C entries
(``dvo_framebuild``, ``dvo_regularize_cull``) and the same buffer layout: it
is built from there (with that tree's headers), held equal to this tree's
kernels bit for bit, and timed in turns with them (the list forwards, then
backwards).  Prints one line per row beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import torch


def empty_launch() -> None:
    """One launch of the empty kernel on the current stream."""
    from dvo_tpu_torch.ops.cuda import _build

    _build.check(_build.library().dvo_floor_empty(_build.stream_handle(torch.device("cuda"))),
                 "floor (empty)")


def copy_launch(src: torch.Tensor, dst: torch.Tensor) -> None:
    """One launch of the copy kernel: ``dst`` = ``src`` (contiguous CUDA
    tensors of the same byte size, a multiple of 16)."""
    from dvo_tpu_torch.ops.cuda import _build

    nbytes = src.numel() * src.element_size()
    if dst.numel() * dst.element_size() != nbytes or not (src.is_contiguous()
                                                          and dst.is_contiguous()):
        raise ValueError("copy_launch: src and dst must be contiguous and of one size")
    _build.check(_build.library().dvo_floor_copy(src.data_ptr(), dst.data_ptr(), nbytes,
                                                 _build.stream_handle(src.device)),
                 "floor (copy)")


def floor_us(nbytes: int, profile) -> dict:
    """Device microseconds of one empty launch and of one copy that moves
    ``nbytes`` (``nbytes / 2`` read, as many written; rounded up to 16-byte
    chunks).  ``profile``: ``chip_smoke.device_profile``."""
    half = -(-nbytes // 32) * 16
    src = torch.zeros(half // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    empty_ops, empty = profile(empty_launch, 20, True)
    copy_ops, copy = profile(lambda: copy_launch(src, dst), 20, True)
    return dict(empty_us=empty, copy_us=copy, copy_bytes=2 * half,
                empty_device_ops=empty_ops, copy_device_ops=copy_ops)


def build_baseline(tree: Path):
    """An earlier commit's ``framebuild.cu``, from its own sources, bound with
    this tree's signatures of the two entries."""
    from dvo_tpu_torch.ops.cuda import _build

    src = tree / "dvo_tpu_torch" / "csrc"
    # a file name of its own per tree: dlopen hands back a library already
    # loaded from the same path
    tag = hashlib.sha256(str(tree.resolve()).encode()).hexdigest()[:12]
    out = _build.BUILD_DIR / f"libdvo_framebuild_baseline_{tag}.{os.getpid()}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(src), "-o",
                           str(out), str(src / "framebuild.cu")], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}) for the baseline:\n{done.stderr}")
    lib = _build.bind(ctypes.CDLL(str(out)), ["dvo_framebuild", "dvo_regularize_cull"])
    out.unlink()
    return lib


def cases(dev):
    """(label, call, work) of the launches the paths make, on the frames of
    ``chip_smoke.py``: the mono tracking build, the mono regularize-and-cull,
    the RGB-D build (gray, depth, sigma and mask)."""
    import chip_smoke as cs
    from dvo_tpu_torch.config import DVOConfig, MapperConfig
    from dvo_tpu_torch.models.frame import normalize_gray
    from dvo_tpu_torch.models.odometry import _cull_chunk, raw_depth
    from dvo_tpu_torch.ops.cuda import framebuild

    cfg = DVOConfig.monocular()
    grays, masks, K, depth = cs.render_sequence(dev)
    _, _, (g, m, d) = _cull_chunk(cfg, K, grays[1], masks[1], depth)
    g = normalize_gray(g)
    s = torch.full_like(d, 0.2)
    cfg_r = DVOConfig.rgbd()
    # the RGB-D build's inputs as chip_smoke.rgbd_kernel_phase makes them
    r_grays, r_masks, r_counts, _ = cs.render_rgbd(dev)
    _, _, (rg, rm, rc) = _cull_chunk(cfg_r, K, r_grays[:2].to(dev), r_masks[:2].to(dev),
                                     r_counts[:2].to(dev))
    rd, rs = raw_depth(rc, cs.DEPTH_SCALE)
    rg, rm, rd, rs = normalize_gray(rg[1]), rm[1] & (rd[1] > 0), rd[1], rs[1]
    L, Lr = cfg.pyramid.levels, cfg_r.pyramid.levels
    shape, rshape = "x".join(map(str, g.shape)), "x".join(map(str, rg.shape))
    return [
        (f"framebuild tracking {shape}x{L}",
         lambda: framebuild.build_pyramid_planes(g, m, None, None, L),
         lambda: framebuild.build_pyramid_planes_plain(g, m, None, None, L),
         framebuild.work(g.shape, L, 1, True)),
        (f"regularize_cull {shape}x{L}",
         lambda: framebuild.regularize_cull_pyramid(d, s, L, MapperConfig()),
         lambda: framebuild.regularize_cull_pyramid_plain(d, s, L, MapperConfig()),
         framebuild.work_regularize_cull(d.shape, L)),
        (f"framebuild rgbd {rshape}x{Lr}",
         lambda: framebuild.build_pyramid_planes(rg, rm, rd, rs, Lr),
         lambda: framebuild.build_pyramid_planes_plain(rg, rm, rd, rs, Lr),
         framebuild.work(rg.shape, Lr, 3, True)),
    ]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", action="append", default=[],
                        help="unpacked tree of an earlier commit to time beside (repeatable)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("framebuild_floor needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from dvo_tpu_torch.ops.cuda import _build

    dev = torch.device("cuda", 0)
    card = cs.card()
    print(card, flush=True)
    _build.library()
    bases = {name: build_baseline(Path(name)) for name in opts.baseline}
    for label, call, plain, (nbytes, flops) in cases(dev):
        got, want = cs._flat(call()), cs._flat(plain())
        if not all(torch.equal(a, b) for a, b in zip(got, want)) or len(got) != len(want):
            raise AssertionError(f"{label}: differs from the plain version")
        fl = floor_us(nbytes, cs.device_profile)
        line = (f"{label}: bound {_build.bound_us(nbytes, flops)[0]:.3f} us, empty launch "
                f"{fl['empty_us']:.2f} us, copy of its {fl['copy_bytes']} B {fl['copy_us']:.2f} us")
        libs = {"this tree": None, **bases}
        for name, lib in bases.items():
            with cs.patched(_build, "library", lambda: lib):
                old = cs._flat(call())
            if not all(torch.equal(a, b) for a, b in zip(old, got)):
                raise AssertionError(f"{label}: {name} differs from this tree's kernel")
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            lib = libs[name]
            with cs.patched(_build, "library", lambda: lib) if lib is not None \
                    else cs.contextlib.nullcontext():
                times[name].append(cs.device_profile(call, 20, True)[1])
        line += "; device us (turns): " + "; ".join(
            f"{name} {' / '.join(f'{t:.2f}' for t in ts)}" for name, ts in times.items())
        print(f"{line} on {card}", flush=True)


if __name__ == "__main__":
    main()
