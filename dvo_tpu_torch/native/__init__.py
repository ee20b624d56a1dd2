"""ctypes bindings for the native C++ data plane (PNG decode, undistortion
remap, threaded prefetch loader) — the port's own copy of ``dvo_tpu.native``.

``loader.cpp`` is compiled at first use (g++ and libpng) into
``dvo_tpu_torch/.build/``, which git ignores; the library's file name
carries the hash of the source and the flags, so an edit rebuilds it.  Every
entry point has a pure-Python counterpart in ``dvo_tpu_torch.utils.datasets``
and the runners pick one route for a whole run
(``utils.runner.decode_route``), so the port works without the native
library: it is a throughput optimisation of the host data plane, mirroring
the reference's C++ loader (src/core/loader.cpp).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / ".build"
_CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]
_LD_FLAGS = ["-shared", "-lpng", "-lz", "-pthread"]
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(_CXX_FLAGS + _LD_FLAGS).encode())
    digest.update(_SOURCE.read_bytes())
    return BUILD_DIR / f"libdvonative_{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp), *_LD_FLAGS],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        try:
            _build(path)
        except (OSError, subprocess.CalledProcessError) as e:
            # no compiler or no libpng headers: decode_route takes PIL
            raise NativeUnavailable(f"native build failed: {e}") from e
    lib = ctypes.CDLL(str(path))
    lib.dvo_png_info.restype = ctypes.c_int
    lib.dvo_png_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dvo_decode_png_f32.restype = ctypes.c_int
    lib.dvo_decode_png_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_float,
    ]
    lib.dvo_remap_nearest.restype = None
    lib.dvo_remap_nearest.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.dvo_prefetch_create.restype = ctypes.c_void_p
    lib.dvo_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    lib.dvo_prefetch_next.restype = ctypes.c_int
    lib.dvo_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.dvo_prefetch_dims.restype = None
    lib.dvo_prefetch_dims.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
    ]
    lib.dvo_prefetch_destroy.restype = None
    lib.dvo_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def png_info(path: str) -> Tuple[int, int, int]:
    lib = load_library()
    w = ctypes.c_int()
    h = ctypes.c_int()
    d = ctypes.c_int()
    rc = lib.dvo_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(d))
    if rc != 0:
        raise IOError(f"png_info({path}) failed: {rc}")
    return w.value, h.value, d.value


def decode_png_f32(path: str, scale: float) -> np.ndarray:
    """Decode to float32 gray * scale (8-bit RGB uses BGR2GRAY luma)."""
    lib = load_library()
    w, h, _ = png_info(path)
    out = np.empty((h, w), np.float32)
    rc = lib.dvo_decode_png_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h,
        ctypes.c_float(scale),
    )
    if rc != 0:
        raise IOError(f"decode_png_f32({path}) failed: {rc}")
    return out


def remap_nearest(src: np.ndarray, map_xy: np.ndarray, border: float):
    lib = load_library()
    src = np.ascontiguousarray(src, np.float32)
    map_xy = np.ascontiguousarray(map_xy, np.float32)
    h, w = map_xy.shape[:2]
    dst = np.empty((h, w), np.float32)
    valid = np.empty((h, w), np.uint8)
    lib.dvo_remap_nearest(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[0], src.shape[1],
        map_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        ctypes.c_float(border),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return dst, valid.astype(bool)


class PrefetchLoader:
    """Threaded decode(+remap) pipeline over a list of PNG paths; yields
    (index, image (H, W) f32, valid (H, W) bool) in order."""

    def __init__(
        self,
        paths: List[str],
        scale: float,
        map_xy: Optional[np.ndarray] = None,
        border: float = 0.0,
        threads: int = 2,
    ):
        lib = load_library()
        w, h, _ = png_info(paths[0])
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        if map_xy is not None:
            map_xy = np.ascontiguousarray(map_xy, np.float32)
            mp = map_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            mh, mw = map_xy.shape[:2]
        else:
            mp, mh, mw = None, 0, 0
        self._keepalive = (arr, map_xy)
        self._lib = lib
        self._handle = lib.dvo_prefetch_create(
            arr, len(paths), w, h, ctypes.c_float(scale), mp, mh, mw,
            ctypes.c_float(border), threads,
        )
        oh = ctypes.c_int()
        ow = ctypes.c_int()
        lib.dvo_prefetch_dims(self._handle, ctypes.byref(oh), ctypes.byref(ow))
        self.shape = (oh.value, ow.value)
        self._n = len(paths)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        h, w = self.shape
        out = np.empty((h, w), np.float32)
        valid = np.empty((h, w), np.uint8)
        idx = self._lib.dvo_prefetch_next(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        self._i += 1
        if idx < 0:
            raise IOError(f"prefetch decode failed at frame {self._i - 1}: {idx}")
        return idx, out, valid.astype(bool)

    def close(self):
        if self._handle:
            self._lib.dvo_prefetch_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
