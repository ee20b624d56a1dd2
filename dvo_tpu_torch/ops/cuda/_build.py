"""Build and load the hand-written Hopper kernels (``dvo_tpu_torch/csrc``).

All ``csrc/*.cu`` files compile with ``nvcc`` into one shared library with
a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so the
build takes seconds.  The library is rebuilt whenever a source or a flag
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
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-fmad=false"]

# Kernel launches since the last ``reset_launches``: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"gn": 0, "epipolar": 0, "regularize": 0, "framebuild": 0}

_lock = threading.Lock()
_library = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dvo_gn_num_blocks": ([_I], _I),
    "dvo_gn_terms": ([_P] * 11 + [_I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P], _I),
    "dvo_regularize": ([_P] * 3 + [_I, _I, _F, _F, _P], _I),
    "dvo_epipolar_num_blocks": ([_I], _I),
    "dvo_epipolar": ([_P] * 9 + [_I, _I, _I, _I] + [_F] * 10 + [_P], _I),
    "dvo_framebuild": ([_P] * 9 + [_I] * 5 + [_P], _I),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.h"))


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


def nvcc_command(out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-o", str(out),
            *(str(s) for s in sources())]


def build() -> Path:
    """Compile the library unless a build of the current sources exists.
    A failed ``nvcc`` raises with its stderr."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
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
