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

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / ".build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]

# Kernel launches since the last ``reset_launches``: each wrapper adds one
# where it launches its kernel, and nowhere else.
LAUNCHES = {"gn": 0, "gn_step": 0, "gn_level": 0, "epipolar": 0, "regularize": 0,
            "framebuild": 0, "regularize_cull": 0, "pose": 0, "ba": 0}

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
    "dvo_gn_terms": ([_P] * 14 + [_I] * 5 + [_F] * 4 + [_I] * 6 + [_P], _I),
    "dvo_gn_step": ([_P] * 6 + [_I] + [_F] * 3 + [_P], _I),
    "dvo_gn_level_blocks": ([_I, _I], _I),
    "dvo_gn_level_threads": ([_I, _I], _I),
    "dvo_gn_level": ([_P] * 17 + [_I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _F, _F, _P], _I),
    "dvo_regularize": ([_P] * 3 + [_I, _I, _F, _F, _P], _I),
    "dvo_regularize_kind": ([], _I),
    "dvo_regularize_block_rows": ([], _I),
    "dvo_regularize_thread_rows": ([], _I),
    "dvo_epipolar_lanes": ([], _I),
    "dvo_epipolar_threads": ([], _I),
    "dvo_epipolar_pixels": ([], _I),
    "dvo_epipolar": ([_P] * 9 + [_I] * 5 + [_F] * 10 + [_P], _I),
    "dvo_epipolar_fused": ([_P] * 17 + [_I] * 10 + [_F] * 11 + [_P], _I),
    "dvo_framebuild": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "dvo_regularize_cull": ([_P] * 3 + [_I] * 4 + [_F, _F, _P], _I),
    "dvo_floor_empty": ([_P], _I),
    "dvo_floor_copy": ([_P, _P, _I, _P], _I),
    "dvo_stage_load": ([], _I),
    "dvo_stage_mark": ([_I, _P], _I),
    "dvo_pose_warm": ([_P] * 3 + [_F, _P], _I),
    "dvo_pose_track": ([_P] * 6 + [_P], _I),
    "dvo_pose_table": ([_P] * 5 + [_I, _P], _I),
    "dvo_pose_emit": ([_P] * 6 + [_P], _I),
    "dvo_graph_if_load": ([], _I),
    "dvo_graph_if_begin": ([_P] * 2 + [_P], _I),
    "dvo_graph_if_end": ([_P], _I),
}


# Graphs captured by ``capture_graph`` since the last ``reset_launches``.
CAPTURES = 0


def reset_launches() -> None:
    global CAPTURES
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    CAPTURES = 0


class _Capture(threading.local):
    def __init__(self):
        self.record = None        # the capture under way in this thread (_Record)
        self.warming = False      # inside capture_graph's warm-up calls


_capture = _Capture()


class _Record:
    """What a capture's conditional regions (``when``) hold for as long as
    the graph lives: the stream their bodies are captured on and the memory
    pools of their allocations (released with the graph)."""

    def __init__(self, device):
        self.device, self.stream, self.pools = device, None, []

    def next_pool(self):
        import torch

        self.pools.append(torch.cuda.graph_pool_handle())
        return self.pools[-1]

    def release(self):
        import torch

        for pool in self.pools:
            torch._C._cuda_releasePool(self.device.index, pool)


def capture_graph(fn, warmup: int = 2, stream=None, keep=(), generators=()):
    """``fn()`` captured into a CUDA graph (``torch.cuda.graph``) on
    ``stream`` (default: a new side stream), into a memory pool of its own,
    after ``warmup`` eager calls on that stream.  Returns (its outputs,
    which every replay rewrites in place; ``replay()``, which launches on
    the current stream; the launches one replay makes, by counter).

    The warm-up calls leave the tensors in ``keep`` and the ``generators``
    as they found them: ``fn`` may write its results into ``keep`` and draw
    from ``generators``.  The generators are registered with the graph, so
    every replay draws what an eager call would draw next and advances them
    as it would.  The counters count a path's frames: the warm-up calls'
    launches are set-up and are taken back out of LAUNCHES, and so are the
    capture's, which records kernels without running them; every replay
    adds the captured launches.  ``fn`` must read nothing back to the host:
    capture raises on a sync.  A region of ``fn`` that runs only where a
    device bool holds is a ``when``: an IF node of the graph."""
    import torch

    global CAPTURES
    side = torch.cuda.Stream() if stream is None else stream
    current = torch.cuda.current_stream()
    saved = [t.clone() for t in keep] if warmup else []
    drawn = [g.get_state() for g in generators]
    before = dict(LAUNCHES)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        _capture.warming = True
        try:
            for _ in range(warmup):
                fn()
        finally:
            _capture.warming = False
        if saved:
            torch._foreach_copy_(list(keep), saved)
    current.wait_stream(side)
    for g, state in zip(generators, drawn):
        g.set_state(state)
    LAUNCHES.update(before)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    record = _capture.record = _Record(side.device)
    try:
        # thread_local: the runners' decode threads may touch CUDA meanwhile.
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            out = fn()
    finally:
        _capture.record = None
    if record.pools:
        weakref.finalize(graph, record.release).atexit = False
    captured = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    LAUNCHES.update(before)
    CAPTURES += 1

    def replay():
        graph.replay()
        for k, n in captured.items():
            LAUNCHES[k] += n

    return out, replay, captured


def when(pred, body, counter: str) -> None:
    """``body(put)`` where the device bool ``pred`` holds, and nothing where
    it does not, with no host read on the card.  The body writes what it
    computes with ``put(destination, value, index=None)`` into tensors made
    before the call (a copy; with ``index``, a 1-D int64 tensor of distinct
    rows, an ``index_copy_`` into those rows of ``destination``) and changes
    nothing else.

    - Inside a ``capture_graph`` capture: the body is captured into the body
      of a CUDA graph IF node (``csrc/graph_if.cu``), which a replay runs
      only where ``pred`` holds.  It is captured on a stream of the
      capture's own, its allocations into a memory pool that lives as long
      as the graph.
    - In ``capture_graph``'s warm-up calls: the body runs whatever ``pred``
      reads (so that its kernels, handles and workspaces exist before the
      capture), and each ``put`` writes a ``torch.where`` on ``pred``.
    - Anywhere else: ``pred`` is read to the host (one sync on the card)
      and the body runs where it holds.

    On the card ``LAUNCHES[counter]`` counts the regions issued, one a
    call, whether the device then runs the body or skips it."""
    import torch

    def put(dst, value, index=None):
        if index is None:
            dst.copy_(value)
        else:
            dst.index_copy_(0, index, value)

    def put_where(dst, value, index=None):
        put(dst, torch.where(pred, value, dst if index is None else dst.index_select(0, index)),
            index)

    cuda = pred.device.type == "cuda"
    if cuda:
        LAUNCHES[counter] += 1
    if cuda and torch.cuda.is_current_stream_capturing():
        with _branch(pred):
            body(put)
    elif cuda and _capture.warming:
        check(library().dvo_graph_if_load(), "dvo_graph_if_load")
        body(put_where)
    elif bool(pred):
        body(put)


@contextlib.contextmanager
def _branch(pred):
    """The block captured into an IF node on ``pred`` (``when``)."""
    import torch

    record = _capture.record
    if record is None:
        raise RuntimeError("a conditional region needs a capture_graph capture")
    if torch._C._autograd._profiler_enabled():
        # torch 2.11 / CUDA 12.8: a graph whose conditional node was captured
        # while a profiler recorded faults (an illegal address) in later
        # replays under a profiler.
        raise RuntimeError("a conditional region cannot be captured while a profiler records: "
                           "start the profiler after the step's first chunk")
    if record.stream is None:
        record.stream = torch.cuda.Stream(record.device)
    pool = record.next_pool()
    lib = library()
    caller = torch.cuda.current_stream(record.device)
    check(lib.dvo_graph_if_begin(pred.data_ptr(), record.stream.cuda_stream, caller.cuda_stream),
          "dvo_graph_if_begin")
    try:
        with torch.cuda.stream(record.stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(record.device.index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(record.device.index, pool)
    finally:
        check(lib.dvo_graph_if_end(record.stream.cuda_stream), "dvo_graph_if_end")


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


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Set the argument and result types of the entry points ``names``
    (default: all of them) on a loaded library."""
    for name in _SIGNATURES if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library
    with _lock:
        if _library is None:
            _library = bind(ctypes.CDLL(str(build())))
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


def row_block(shape, y_offset, full_shape) -> tuple:
    """The (full_h, full_w) of a row block of ``shape`` = (h, w) that starts
    at image row ``y_offset`` (the block's own shape when ``full_shape`` is
    None).  Raises unless the block is whole rows inside the image: the
    kernels index the block's planes and the full image's with one width."""
    h, w = shape
    full_h, full_w = (h, w) if full_shape is None else (int(v) for v in full_shape)
    if full_w != w or not 0 <= int(y_offset) <= full_h - h:
        raise ValueError(f"a ({h}, {w}) row block at row {y_offset} does not lie in a "
                         f"({full_h}, {full_w}) image")
    return full_h, full_w
