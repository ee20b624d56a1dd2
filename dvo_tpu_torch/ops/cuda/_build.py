"""Build and load the hand-written Hopper kernels (``dvo_tpu_torch/csrc``).

All ``csrc/*.cu`` files compile with ``nvcc`` (one process per source, all
started together) and link into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so the build takes
seconds.  The library is rebuilt whenever a source or a flag
changes (its file name carries their hash) and is written into
``dvo_tpu_torch/.build/``, which git ignores.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.

FMA contraction is off (``-fmad=false``): the kernels then round every
multiply and add separately, exactly as the op-by-op plain PyTorch
versions do, so per-pixel values (and so the strict ``<`` gates and the
epipolar argmin) agree with them bit for bit where the operation order is
the same.  What remains between a kernel and its plain version is summation
order (GN's block reduction) and the plain version's batched 3x3 matmuls;
the tolerances in ``chip_smoke.py`` are set for that.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / ".build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]

# Kernel launches since the last ``reset_launches``: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"gn": 0, "gn_level": 0, "epipolar": 0, "regularize": 0, "framebuild": 0}

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory and
# float32 outside the tensor cores.  A kernel's bound is taken against them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12

_lock = threading.Lock()
_library = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dvo_gn_num_blocks": ([_I], _I),
    "dvo_gn_terms": ([_P] * 11 + [_I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P], _I),
    "dvo_gn_level": ([_P] * 17 + [_I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _F, _F, _P], _I),
    "dvo_regularize": ([_P] * 3 + [_I, _I, _F, _F, _P], _I),
    "dvo_epipolar_num_blocks": ([_I], _I),
    "dvo_epipolar": ([_P] * 9 + [_I, _I, _I, _I] + [_F] * 10 + [_P], _I),
    "dvo_framebuild": ([_P] * 9 + [_I] * 5 + [_P], _I),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bound_us(nbytes: int, flops: int):
    """The least time the card could take for ``nbytes`` moved and ``flops``
    float32 operations, in microseconds, and which of the two sets it
    ("bytes" or "operations")."""
    t_bytes = 1e6 * nbytes / PEAK_BYTES_PER_S
    t_flops = 1e6 * flops / PEAK_FLOPS_F32
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.h")) + sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + _headers():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libdvo_kernels_{digest.hexdigest()[:16]}.so"


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def compile_command(src: Path, obj: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-c", str(src), "-o", str(obj)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(out), *(str(o) for o in objs)]


def build() -> Path:
    """Compile the library unless a build of the current sources exists:
    every source in its own ``nvcc`` process, all running at once, then one
    link.  A failed ``nvcc`` raises with its stderr."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        procs = [subprocess.Popen(compile_command(src, obj), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources(), objs)]
        results = [(p.args, p.communicate()[1], p.returncode) for p in procs]
        link = subprocess.run(link_command(objs, tmp), capture_output=True, text=True)
        results.append((link.args, link.stderr, link.returncode))
        for args, stderr, code in results:
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}): {' '.join(args)}\n{stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    finally:
        for path in objs + [tmp]:
            path.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _library = lib
        return _library


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — the kernels take raw pointers and check nothing."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
