"""Full-sequence runners — ``dvo_tpu.utils.runner`` ported: a dataset in,
(timestamps, (N, 4, 4) world poses, per-frame seconds) out, for the
monocular, RGB-D and Kinect dual-camera modes.

Host data plane.  Frames are decoded by ``dvo_tpu_torch.native`` (C++ decode,
undistortion remap and prefetch threads) when its library loads or builds,
else by PIL and NumPy on a pool of ``PIL_THREADS`` threads, in order, at
most ``PIL_AHEAD`` frames ahead of the caller (``decode_route``); that choice
is the runner's only fallback.  The undistortion map is composed with the
``2**culls`` pre-cull stride (``_composed_cull_map``), so frames arrive at
the tracking base resolution and the device runs with ``culls=0``.
The two routes decode 8-bit gray and 16-bit depth PNGs to the same values.
From color PNGs (the Kinect color camera) PIL's ``convert("L")`` rounds the
luma to a whole level where native keeps its fraction: the per-frame path's
gray then differs by at most half a level (0.5 / 255), and the chunked
path, which rounds both, by one level on the pixels whose luma lies within
about 1e-4 of a half level (0.05% of random colors).

Chunked path (``chunk`` > 1).  Each chunk of raw frames (uint8 gray,
uint16 depth counts) is filled into one of two sets of staging tensors —
pinned host memory on CUDA — and shipped with non-blocking copies; a set is
refilled only after the event recorded behind its last copy has completed
(``_Staging``).  The validity mask is constant per rig and goes to the
device once.  A chunk's results are packed on the device into one (N, D)
float32 tensor, copied into pinned memory without blocking, and read on the
host only after the NEXT chunk has been dispatched (``_ChunkDrain``).
Nothing inside a chunk's dispatch waits for the device: the monocular step
decides promotion on the device (``models/odometry.py``; with ``--ba`` it
reads the decision once per frame).

Pose graph (``run_monocular(pose_graph=True)``).  On the per-frame path the
harvester sees every step's result and state.  On the chunked path it sees
the drained rows, the chunk's own host frames and one packed copy of the
keyframe ring per chunk, which rides the same pinned, event-gated copy as
the results (``_ChunkedHarvest``); a live refinement reaches the device
state two chunks after the promotion that triggered it.

Randomness: ``seed`` seeds the ``torch.Generator`` on the run's device that
draws the monocular bootstrap noise and the depth-filter reset planes.
Torch cannot replay ``jax.random``, so a monocular trajectory differs from
``dvo_tpu``'s for the same seed.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import DVOConfig
from dvo_tpu_torch.models import graphed, posegraph
from dvo_tpu_torch.models.odometry import (
    monocular_init,
    monocular_init_with_depth,
    monocular_run,
    monocular_step,
    rgbd_init,
    rgbd_run,
    rgbd_run_raw,
    rgbd_step,
)
from dvo_tpu_torch.ops.warp import map_depth_to_gray
from dvo_tpu_torch.utils.datasets import (
    TUM_DEPTH_SCALE,
    Calibration,
    KinectCalibration,
    build_undistort_map,
    decode_gray,
    remap_nearest,
)
from dvo_tpu_torch.utils import trace
from dvo_tpu_torch.utils.metrics import (
    device_sync,
    fetch,
    fetch_start,
    fetch_wait,
    to_numpy,
    tree_map,
)

_MASK_ERROR = ("chunked path requires a constant validity mask (it is shipped once); "
               "got a frame-varying mask")


def _check_mask(mask, mask_full) -> None:
    if not np.array_equal(np.asarray(mask), mask_full):
        raise ValueError(_MASK_ERROR)


# ----------------------------------------------------- chunked result plumbing

def _leaves(tree):
    """The tensors of a tree of dataclasses, in field order."""
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) for leaf in _leaves(getattr(tree, f.name))]
    return [tree]


def _row_size(leaf) -> int:
    return int(np.prod(leaf.shape[1:], dtype=np.int64))


def _flatten_results(res) -> torch.Tensor:
    """Device side: every leaf of a stacked result as (N, D) float32,
    concatenated into one (N, sum D) tensor."""
    leaves = _leaves(res)
    n = leaves[0].shape[0]
    return torch.cat([leaf.reshape(n, _row_size(leaf)).to(torch.float32) for leaf in leaves],
                     dim=1)


def _unflatten_results(template, flat: np.ndarray):
    """Host side: (N, D) numpy -> ``template``'s tree with numpy leaves of
    its shapes and dtypes.  The integer fields are counts far below 2**24,
    so their float32 round trip is exact."""
    off = 0

    def take(leaf):
        nonlocal off
        size = _row_size(leaf)
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        arr = flat[:, off:off + size].reshape(tuple(leaf.shape)).astype(dtype)
        off += size
        return arr

    return tree_map(take, template)


class _ChunkDrain:
    """Pipelined consumer of chunk results.  ``push`` packs the current
    chunk's results on the device, starts their copy into pinned host
    memory and records an event behind it, then consumes the PREVIOUS
    chunk's rows — so the device runs chunk k+1 while the host walks chunk
    k's.  ``_consume`` waits on its chunk's event and on nothing earlier.
    ``finish`` drains the last chunk.  ``aux`` (optional, a device tensor:
    the pose-graph harvester's snapshot of the keyframe ring) rides the same
    kind of copy and comes back as numpy in ``on_chunk_done(first_index,
    count, aux)``, called once a chunk's rows are consumed."""

    def __init__(self, on_frame, on_chunk_done=None):
        self._on_frame = on_frame   # on_frame(step_index, result_row)
        self._on_chunk_done = on_chunk_done
        self._pending = None

    def push(self, res, first_index: int, count: int, aux=None) -> None:
        flat = fetch_start(_flatten_results(res))
        aux = None if aux is None else fetch_start(aux)
        prev, self._pending = self._pending, (res, flat, aux, first_index, count)
        if prev is not None:
            self._consume(*prev)

    def finish(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._consume(*pending)

    def _consume(self, res, flat, aux, first_index, count) -> None:
        rows = _unflatten_results(res, fetch_wait(*flat))
        for k in range(count):
            self._on_frame(first_index + k, tree_map(lambda a: a[k], rows))
        if self._on_chunk_done is not None:
            self._on_chunk_done(first_index, count,
                                None if aux is None else fetch_wait(*aux))


class _Staging:
    """Two sets of host tensors that chunk inputs are filled into.  On CUDA
    they are pinned, each upload is one non-blocking copy per tensor with an
    event recorded behind it, and a set is handed out for refilling only
    once its last upload's event has completed: refilling it earlier would
    change frames still in flight.  On the CPU ``upload`` copies."""

    def __init__(self, specs, device):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._sets = [[torch.empty(shape, dtype=dtype, pin_memory=self._cuda)
                       for shape, dtype in specs] for _ in range(2)]
        self._events = [None, None]
        self._next = 0

    def acquire(self):
        """The next set's host buffers, as numpy views, free to fill."""
        i = self._next
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        return [t.numpy() for t in self._sets[i]]

    def upload(self):
        """Ship the set last acquired to the device; returns the device
        tensors."""
        i = self._next
        out = [t.to(self._device, non_blocking=True, copy=True) for t in self._sets[i]]
        if self._cuda:
            self._events[i] = torch.cuda.Event()
            self._events[i].record()
        self._next = 1 - i
        return out


def _run_chunks(n_steps, chunk, staging, fill_row, dispatch, on_frame, on_chunk_done=None,
                make_aux=None, before_dispatch=None):
    """Drive ``n_steps // chunk`` full chunks: fill a staging set from the
    (prefetching) stream, upload it, dispatch the chunk (``dispatch(device
    tensors)`` returns its stacked results) and consume the previous
    chunk's results.  Returns (steps consumed, per-chunk wall seconds); the
    first chunk's wall carries the one-time costs (CUDA context, the
    kernels' build), and the caller runs the tail per frame.

    The pose graph's hooks: ``before_dispatch()`` runs just before each
    chunk's dispatch (where a live refinement's corrections reach the device
    state); ``make_aux()`` just after it (its device tensor rides the drain
    and comes back in ``on_chunk_done``: the chunk's ring snapshot).

    Traced (``utils/trace``), each chunk shows as the host spans
    ``dvo.fill`` (the staging rows from the stream), ``dvo.upload``,
    ``dvo.dispatch`` (the chunk's call) and ``dvo.drain`` (the results'
    copy started, the previous chunk's rows consumed)."""
    drain = _ChunkDrain(on_frame, on_chunk_done)
    done = 0
    chunk_walls = []
    t_prev = time.perf_counter()
    for _ in range(n_steps // chunk):
        with trace.span("fill"):
            bufs = staging.acquire()
            for k in range(chunk):
                fill_row(bufs, k)
        if before_dispatch is not None:
            before_dispatch()
        with trace.span("upload"):
            uploaded = staging.upload()
        with trace.span("dispatch"):
            res = dispatch(uploaded)
        with trace.span("drain"):
            drain.push(res, done, chunk, make_aux() if make_aux is not None else None)
        done += chunk
        t_now = time.perf_counter()
        chunk_walls.append(t_now - t_prev)
        t_prev = t_now
    with trace.span("drain"):
        drain.finish()
    if chunk_walls:
        # The final drain waits for the last chunk's execution.
        chunk_walls[-1] += time.perf_counter() - t_prev
    return done, chunk_walls


# ------------------------------------------------------------ host data plane

@functools.cache
def decode_route() -> str:
    """``"native"`` when ``dvo_tpu_torch.native``'s library loads, or builds
    (g++ and libpng): C++ decode and remap on prefetch threads.  Otherwise
    ``"pil"``: PIL and NumPy on a thread pool (``_pooled``; PIL releases the
    GIL while it decodes)."""
    from dvo_tpu_torch import native

    try:
        native.load_library()
    except (native.NativeUnavailable, OSError):
        return "pil"
    return "native"


def _png_dims(path):
    """(h, w) of an image from its header only."""
    if decode_route() == "native":
        from dvo_tpu_torch import native

        w, h, _ = native.png_info(path)
        return h, w
    from PIL import Image

    with Image.open(path) as img:
        w, h = img.size
    return h, w


def _composed_cull_map(srcmap, first_path, st: int):
    """Undistortion composed with a ``st`` point-sample stride into one
    dest->src map, so the loader emits pre-culled frames.  Exact: the
    remap of the culled map equals ``remap_full[::st, ::st]``.
    ``srcmap=None`` (no undistortion) gives the identity stride map from
    the first frame's header."""
    if srcmap is not None:
        return np.ascontiguousarray(srcmap[::st, ::st]) if st > 1 else srcmap
    if st <= 1:
        return None
    h, w = _png_dims(first_path)
    xs = np.arange(0, w, st, dtype=np.float32)
    ys = np.arange(0, h, st, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.ascontiguousarray(np.stack([gx, gy], axis=-1))


# The PIL route's pool: threads, and frames decoded ahead of the caller (the
# bound on decoded frames held at once).  PIL_THREADS = 1 decodes on the
# calling thread.
PIL_THREADS = max(2, min(8, os.cpu_count() or 2))
PIL_AHEAD = 2 * PIL_THREADS


def _pooled(fn, items, threads: int, ahead: int):
    """Yield ``fn(item)`` for every item, in the items' order, computed on a
    pool of ``threads`` threads with at most ``ahead`` items submitted and
    not yet yielded.  An exception raised by ``fn`` reaches the caller when
    its item's turn comes; work not yet started is cancelled when the caller
    stops early or an item fails."""
    items = iter(items)
    pool = ThreadPoolExecutor(max_workers=threads, thread_name_prefix="pil-decode")
    try:
        pending = collections.deque(pool.submit(fn, it) for _, it in zip(range(ahead), items))
        while pending:
            out = pending.popleft().result()
            for it in items:
                pending.append(pool.submit(fn, it))
                break
            yield out
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _decode_pil(path, scale, srcmap):
    """One frame on the PIL route: (image float32 * scale, valid bool)."""
    img = decode_gray(path) * scale
    if srcmap is not None:
        img, valid = remap_nearest(img, srcmap, border=0.0)
    else:
        valid = np.ones_like(img, bool)
    return img.astype(np.float32), valid


def _image_stream(paths, scale, srcmap, loaders: list):
    """Yield (image float32 * scale, valid bool) per path, decoded (and
    remapped) by ``decode_route()``.  A native loader is appended to
    ``loaders`` so that the caller closes it."""
    if decode_route() == "native":
        from dvo_tpu_torch import native

        loader = native.PrefetchLoader(list(paths), scale, map_xy=srcmap, border=0.0,
                                       threads=max(2, os.cpu_count() or 2))
        loaders.append(loader)
        for _idx, img, valid in loader:
            yield img, valid
        return
    decode = functools.partial(_decode_pil, scale=scale, srcmap=srcmap)
    if PIL_THREADS <= 1:
        yield from map(decode, paths)
    else:
        yield from _pooled(decode, paths, PIL_THREADS, PIL_AHEAD)


def _close(loaders) -> None:
    for ld in loaders:
        ld.close()


def quantize(gray: np.ndarray) -> np.ndarray:
    """Fractional luma -> the nearest gray level (the reference's
    cvtColor->8U, loader.cpp:59)."""
    return np.rint(gray).astype(np.uint8)


def _device_cfg(cfg: DVOConfig, K, st: int, device):
    """(cfg with culls=0, K / st on ``device``) for frames the loader has
    already culled by ``st`` (``cull_intrinsic`` semantics, on the host)."""
    K_host = np.asarray(K, np.float32).copy()
    if cfg.pyramid.culls:
        K_host[:2] /= st
        cfg = dataclasses.replace(cfg, pyramid=dataclasses.replace(cfg.pyramid, culls=0))
    return cfg, torch.tensor(K_host, device=device)


class _Trajectory:
    """What a runner keeps of each frame: pose, timestamp and seconds, the
    metrics record and the verbose line.  ``chunked`` runs the chunked
    path's full chunks, ``step`` one frame of the per-frame path (or the
    tail); ``mono`` adds the keyframe and mapper fields to the verbose
    line."""

    def __init__(self, items, metrics, verbose: bool, mono: bool = False):
        self._items, self._metrics, self._verbose, self._mono = items, metrics, verbose, mono
        self.poses = [np.eye(4, dtype=np.float32)]
        self.times = [items[0].timestamp]
        self.secs = []

    def _record(self, fi, row, sec, suffix, pose=None) -> None:
        self.poses.append(to_numpy(row.T_world) if pose is None else pose)
        self.times.append(self._items[fi].timestamp)
        if self._metrics is not None:
            self._metrics.log_frame(row, sec, self._items[fi].timestamp)
        if self._verbose:
            kf = (f" kf={bool(row.is_keyframe)} acc={int(row.mapping.accepted):5d}"
                  if self._mono else "")
            print(f"frame {fi:4d}{kf} {suffix}")

    def chunked(self, chunk, staging, fill_row, dispatch, pose_of=None, **hooks) -> int:
        """``_run_chunks`` over the steps after frame 0, every row
        recorded with the mean seconds so far; returns the first frame
        left for the per-frame tail.  ``pose_of(step_index, row)`` gives
        the pose to emit instead of the row's (the pose graph's corrected
        one); ``hooks`` are ``_run_chunks``'s."""
        t_sec = time.perf_counter()

        def on_frame(step_idx, row):
            self._record(1 + step_idx, row, (time.perf_counter() - t_sec) / (step_idx + 1),
                         "(chunked)", None if pose_of is None else pose_of(step_idx, row))

        done, chunk_walls = _run_chunks(len(self._items) - 1, chunk, staging, fill_row,
                                        dispatch, on_frame, **hooks)
        self.secs.extend(cw / chunk for cw in chunk_walls for _ in range(chunk))
        return 1 + done

    def step(self, fi, step_fn, *args):
        """``step_fn(*args)`` -> (state, StepResult) for frame ``fi``, timed
        to its completion on the device; returns the state."""
        t0 = time.perf_counter()
        state, res = step_fn(*args)
        device_sync(res.T_world)
        self.secs.append(time.perf_counter() - t0)
        self._record(fi, res, self.secs[-1], f"{self.secs[-1] * 1e3:7.1f} ms")
        self.last_result = res
        return state

    def result(self):
        return np.asarray(self.times), np.stack(self.poses), np.asarray(self.secs)


class _ChunkedHarvest:
    """The pose graph on the chunked path.  Constraints are harvested from
    the drained ``StepResult`` rows; keyframe gray snapshots are the chunk's
    own host rows; the retiring keyframes' refined depth and sigma come from
    one packed ring fetch per chunk, which rides the drain's pinned copy
    behind the next chunk's execution.  A live refinement
    (``pose_graph_every``) reaches the device state two chunks after the
    promotion that triggered it (results drain one chunk behind); the rows
    emitted in between are corrected afterwards, so that the final
    ``apply_refinement`` sees one consistent chain (``corr_records``: frames
    in [from_frame, effective_frame) were composed from the reference before
    its correction)."""

    def __init__(self, harvester, out: "_Trajectory", chunk: int, mask_full, capacity: int,
                 shape):
        self.harvester, self._out, self._chunk = harvester, out, chunk
        self._mask_full, self._cap, self._shape = mask_full, capacity, shape
        self._corr_records = []    # (from_frame, effective_frame, corr 4x4)
        self._pending_corr = []    # refinements waiting for the device state
        self._chunk_grays = {}     # first step index -> host uint8 rows
        self._refine_due = False
        self._dispatched = 0
        self.filling = None        # the staging rows being filled (set by the runner)

    def keep_grays(self) -> None:
        """Keep the host rows of the chunk about to be dispatched (a copy:
        the staging set is refilled two chunks later)."""
        self._chunk_grays[self._dispatched * self._chunk] = self.filling.copy()
        self._dispatched += 1

    @staticmethod
    def pack_ring(history) -> torch.Tensor:
        """Depth, sigma and ``kf_id`` of the ring in one float32 vector
        (frame ids are exact far below 2**24): ``kf_id`` lets
        ``absorb_ring`` find the slots overwritten between a retirement and
        this fetch."""
        return torch.cat([history.depth.reshape(-1), history.sigma.reshape(-1),
                          history.kf_id.to(torch.float32)])

    def absorb(self, ring: np.ndarray) -> None:
        n = self._cap * self._shape[0] * self._shape[1]
        self.harvester.absorb_ring(ring[:n].reshape(self._cap, *self._shape),
                                   ring[n:2 * n].reshape(self._cap, *self._shape),
                                   ring[2 * n:].astype(np.int64))

    def pose_of(self, step_idx: int, row):
        """The pose to emit for a drained row, and the harvest of a
        keyframe row."""
        fi = 1 + step_idx
        T = np.asarray(row.T_world)
        for first, effective, corr in self._corr_records:
            if first <= fi < effective:
                T = corr @ T
        if bool(row.is_keyframe):
            first = (step_idx // self._chunk) * self._chunk
            due = self.harvester.on_chunk_row(fi, row, self._chunk_grays[first][step_idx - first],
                                              self._mask_full, T_emit=T)
            self._refine_due = self._refine_due or due
        return T

    def on_chunk_done(self, first_index: int, count: int, ring) -> None:
        self._chunk_grays.pop(first_index, None)
        self.absorb(ring)
        if self._refine_due:
            self._refine_due = False
            refined = self.harvester.refine_live_chunked()
            if refined is not None:
                self._pending_corr.append(refined)

    def apply_pending(self, state):
        """Write the refinements that are waiting into ``state`` (ring and
        reference) and into the rows already emitted; returns the state."""
        nodes, poses = self.harvester.nodes, self._out.poses
        for xi_ref, corr in self._pending_corr:
            m_nodes = len(xi_ref)
            xi_slot = np.zeros((self._cap, 6), np.float32)
            id_slot = np.full((self._cap,), -2, np.int32)
            # Node k is ring push k+1 (push 0 is the first keyframe), in
            # slot push % capacity.
            for k in range(max(0, m_nodes - self._cap), m_nodes):
                slot = (k + 1) % self._cap
                xi_slot[slot] = xi_ref[k]
                id_slot[slot] = nodes[k].frame_idx
            max_id = nodes[m_nodes - 1].frame_idx
            state = posegraph.apply_live_correction(state, xi_slot, id_slot, max_id, corr)
            # Rows already drained on the old chain (the refined keyframe's
            # own and those after it) are corrected in place: the final
            # apply_refinement trusts inv(poses[kf]) @ poses[f] as tracked
            # motion and would otherwise apply the correction twice to what
            # follows (corr @ T_old(kf) == T_new(kf), so the keyframe's row
            # lands on its refined pose).
            for fi_done in range(max_id, len(poses)):
                poses[fi_done] = (corr @ poses[fi_done]).astype(np.float32)
            self._corr_records.append((max_id, 1 + self._dispatched * self._chunk, corr))
        self._pending_corr.clear()
        return state


# ------------------------------------------------------------------ monocular

def run_monocular(
    sequence,
    calib: Calibration,
    cfg: DVOConfig = DVOConfig.monocular(),
    seed: int = 0,
    max_frames: Optional[int] = None,
    undistort: bool = True,
    verbose: bool = False,
    metrics=None,
    checkpoint_out: Optional[str] = None,
    gallery_out: Optional[str] = None,
    pose_graph: bool = False,
    pose_graph_every: int = 0,
    chunk: int = 0,
    device="cuda",
):
    """Monocular VO over a sequence.  Returns (timestamps, poses (N, 4, 4),
    per-frame seconds).  ``metrics``: a ``MetricsLogger``;
    ``checkpoint_out``: ``.npz`` path for the final state
    (``utils.checkpoint``); ``gallery_out``: PNG path for the final
    keyframe-ring gallery.

    ``chunk`` > 1 selects the chunked path (module docstring): uint8
    frames, normalised on the device, through ``monocular_run``.  Gray from
    color sources is quantised to integer levels (rint -> uint8; 8-bit gray
    sources are exact), so the trajectory matches the per-frame path (gray
    / 255 floats) to float noise.  The tail (len-1 mod chunk) runs per
    frame on the same quantised pixels.

    ``pose_graph``: harvest odometry, BA-window and loop-closure constraints
    during the run (``models/posegraph``), on either path, and refine the
    keyframe trajectory at the sequence's end: the returned poses are then
    the refined ones.  ``pose_graph_every`` = K > 0 (with ``pose_graph``)
    also refines every K promotions and writes the corrections into the live
    keyframe ring."""
    device = torch.device(device)
    srcmap = build_undistort_map(calib) if undistort and calib.distortion is not None else None
    items = list(sequence)[:max_frames]
    use_chunk = bool(chunk and chunk > 1) and len(items) > chunk
    st = 2 ** cfg.pyramid.culls if use_chunk else 1
    stream_map = _composed_cull_map(srcmap, items[0].gray_path, st) if use_chunk else srcmap
    generator = torch.Generator(device=device).manual_seed(seed)
    loaders: list = []
    try:
        stream = _image_stream([it.gray_path for it in items], 1.0 if use_chunk else 1 / 255.0,
                               stream_map, loaders)
        gray, mask = next(stream)
        out = _Trajectory(items, metrics, verbose, mono=True)
        start_fi = 1
        harvester = harvest = None
        if use_chunk:
            cfg_step, K_step = _device_cfg(cfg, calib.K, st, device)
            gray_c = quantize(gray)
            h, w = gray_c.shape
            mask_full = np.asarray(mask)
            mask_step = torch.from_numpy(mask_full).to(device)
            state = monocular_init(torch.from_numpy(gray_c), mask_step, K_step, cfg_step,
                                   device=device, generator=generator)
            hooks = {}
            if pose_graph:
                harvester = posegraph.PoseGraphHarvester(
                    cfg_step, to_numpy(K_step), verbose=verbose, refine_every=pose_graph_every,
                    device=device)
                harvest = _ChunkedHarvest(harvester, out, chunk, mask_full,
                                          cfg_step.mapper.history_capacity, (h, w))

                def apply_pending():
                    nonlocal state
                    corrected = harvest.apply_pending(state)
                    graphed.carry(corrected, state)   # the next chunk replays, no new capture
                    state = corrected

                hooks = dict(pose_of=harvest.pose_of, on_chunk_done=harvest.on_chunk_done,
                             make_aux=lambda: harvest.pack_ring(state.history),
                             before_dispatch=apply_pending)

            def fill_row(bufs, k):
                g, m = next(stream)
                _check_mask(m, mask_full)
                bufs[0][k] = quantize(g)
                if harvest is not None:
                    harvest.filling = bufs[0]

            def dispatch(bufs):
                nonlocal state
                if harvest is not None:
                    harvest.keep_grays()
                state, res = monocular_run(state, bufs[0], mask_step, K_step, cfg_step)
                return res

            start_fi = out.chunked(chunk, _Staging([((chunk, h, w), torch.uint8)], device),
                                   fill_row, dispatch, **hooks)
            if harvest is not None:
                # A refinement that the last chunks triggered reaches the
                # state the tail runs on.
                apply_pending()
        else:
            cfg_step, K_step = cfg, torch.tensor(np.asarray(calib.K, np.float32), device=device)
            state = monocular_init(torch.from_numpy(gray), torch.from_numpy(mask), K_step, cfg,
                                   device=device, generator=generator)
            if pose_graph:
                harvester = posegraph.PoseGraphHarvester(
                    cfg, np.asarray(calib.K), verbose=verbose, refine_every=pose_graph_every,
                    device=device)

        for fi in range(start_fi, len(items)):
            gray, mask = next(stream)
            if use_chunk:
                # The tail arrives pre-culled from the raw-count stream:
                # quantised as the chunk rows were, on the staged mask.
                gray = quantize(gray)
                _check_mask(mask, mask_full)
                mask_t = mask_step
            else:
                mask_t = torch.from_numpy(mask)
            state = out.step(fi, monocular_step, state, torch.from_numpy(gray), mask_t, K_step,
                             cfg_step)
            if harvester is None:
                continue
            res = out.last_result
            if use_chunk:
                # Tail keyframes harvest as chunk rows do; their deferred
                # ring snapshots resolve in the last absorb below.
                if bool(res.is_keyframe):
                    harvester.on_chunk_row(fi, res, gray, mask_full)
                continue
            corrected = harvester.on_frame(fi, res, state, gray, mask)
            if corrected is not None:
                # This frame is the refined keyframe: its pose is emitted
                # again as corrected, or the frames tracked against the
                # corrected reference would get the correction a second time
                # from finalize's apply_refinement.
                state = corrected
                out.poses[-1] = to_numpy(lie.se3_exp(corrected.ref.xi))
    finally:
        _close(loaders)
    times, poses, secs = out.result()
    if harvester is not None:
        if harvest is not None and harvester._pending_snaps:
            harvest.absorb(fetch(harvest.pack_ring(state.history)))
        poses, pg_costs = harvester.finalize(times, poses, state)
        if verbose and pg_costs.size:
            print(f"pose-graph: {len(harvester.nodes)} nodes, {len(harvester.e_w)} edges "
                  f"({harvester.closures} closures), cost {pg_costs[0]:.3e} -> "
                  f"{pg_costs[-1]:.3e}")
    if checkpoint_out:
        from dvo_tpu_torch.utils.checkpoint import save_state

        save_state(checkpoint_out, state)
    if gallery_out:
        from dvo_tpu_torch.utils.viz import keyframe_gallery, save_png

        save_png(gallery_out, keyframe_gallery(state.history))
    return times, poses, secs


# ---------------------------------------------------------------------- RGB-D

def run_rgbd(
    sequence,
    calib: Calibration,
    cfg: DVOConfig = DVOConfig.rgbd(),
    depth_sigma: float = 0.1,
    max_frames: Optional[int] = None,
    undistort: bool = True,
    verbose: bool = False,
    metrics=None,
    chunk: int = 0,
    device="cuda",
):
    """RGB-D frame-to-frame tracking (odometrizeUsingDepth).  Depth pixels
    with no measurement get sigma 1.0, measured ones ``depth_sigma``
    (transform.cpp:74).  Returns (timestamps, poses, secs).

    ``chunk`` > 1: the chunked path ships raw uint8 gray and uint16 depth
    counts per chunk and runs ``rgbd_run_raw`` (conversion and sigma on the
    device); nothing in a chunk's dispatch waits for the device."""
    device = torch.device(device)
    srcmap = build_undistort_map(calib) if undistort and calib.distortion is not None else None
    items = list(sequence)[:max_frames]
    use_chunk = bool(chunk and chunk > 1) and len(items) > chunk
    st = 2 ** cfg.pyramid.culls if use_chunk else 1
    gmap = _composed_cull_map(srcmap, items[0].gray_path, st) if use_chunk else srcmap
    dmap = _composed_cull_map(srcmap, items[0].depth_path, st) if use_chunk else srcmap
    loaders: list = []

    def to_dev(*arrays):
        return (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)

    try:
        gray_stream = _image_stream([it.gray_path for it in items],
                                    1.0 if use_chunk else 1 / 255.0, gmap, loaders)
        depth_stream = _image_stream([it.depth_path for it in items],
                                     1.0 if use_chunk else 1.0 / TUM_DEPTH_SCALE, dmap, loaders)

        def prep_raw():
            """(gray, mask, depth counts) — a chunked-mode row."""
            gray, mask = next(gray_stream)
            depth, _ = next(depth_stream)
            return gray, mask, depth

        def prep():
            gray, mask, depth = prep_raw()
            if use_chunk:
                # Raw-count streams: normalise on the host, gray quantised
                # exactly as the chunk rows are.
                gray = quantize(gray).astype(np.float32) * np.float32(1.0 / 255.0)
                depth = depth.astype(np.float32) * np.float32(1.0 / TUM_DEPTH_SCALE)
            sigma = np.where(depth > 1e-6, depth_sigma, 1.0).astype(np.float32)
            return gray, mask, depth.astype(np.float32), sigma

        out = _Trajectory(items, metrics, verbose)
        start_fi = 1
        if use_chunk:
            cfg_step, K_step = _device_cfg(cfg, calib.K, st, device)
            g0, m0, d0 = prep_raw()
            mask_full = np.asarray(m0)
            mask_step = torch.from_numpy(mask_full).to(device)
            gray_c = quantize(g0)
            depth_c = d0.astype(np.float32) * np.float32(1.0 / TUM_DEPTH_SCALE)
            sigma_c = np.where(depth_c > 1e-6, depth_sigma, 1.0).astype(np.float32)
            state = rgbd_init(*to_dev(gray_c), mask_step, *to_dev(depth_c, sigma_c), K_step,
                              cfg_step, device=device)
            h, w = gray_c.shape

            def fill_row(bufs, k):
                g, m, d = prep_raw()
                _check_mask(m, mask_full)
                bufs[0][k] = np.rint(g)   # fractional luma -> nearest level
                bufs[1][k] = d            # depth counts are exact integers

            def dispatch(bufs):
                nonlocal state
                state, res = rgbd_run_raw(state, bufs[0], mask_step, bufs[1], K_step, cfg_step,
                                          TUM_DEPTH_SCALE, depth_sigma)
                return res

            staging = _Staging([((chunk, h, w), torch.uint8), ((chunk, h, w), torch.uint16)],
                               device)
            start_fi = out.chunked(chunk, staging, fill_row, dispatch)
        else:
            cfg_step, K_step = cfg, torch.tensor(np.asarray(calib.K, np.float32), device=device)
            gray, mask, depth, sigma = prep()
            state = rgbd_init(*to_dev(gray, mask, depth, sigma), K_step, cfg, device=device)

        for fi in range(start_fi, len(items)):
            gray, mask, depth, sigma = prep()
            if use_chunk:
                _check_mask(mask, mask_full)
                mask_t = mask_step
            else:
                (mask_t,) = to_dev(mask)
            state = out.step(fi, rgbd_step, state, *to_dev(gray), mask_t, *to_dev(depth, sigma),
                             K_step, cfg_step)
    finally:
        _close(loaders)
    return out.result()


# --------------------------------------------------------------------- Kinect

def run_kinect(
    sequence,
    kcalib: KinectCalibration = None,
    cfg: DVOConfig = None,
    mode: str = "mono",
    max_frames: Optional[int] = None,
    undistort: bool = True,
    verbose: bool = False,
    metrics=None,
    chunk: int = 0,
    gray_cull: int = 2,
    device="cuda",
):
    """Kinect v2 dual-camera pipeline (KinectLoader::getMappedImages,
    loader.cpp:90-101, and test/kinect-vo.cpp): undistort color and depth
    with their own intrinsics, register the color image into the depth
    camera's frame on the device (``map_depth_to_gray``), and run VO at the
    depth resolution with the depth camera's K.

    ``mode="mono"``: the monocular pipeline seeded with the first frame's
    measured depth (its generator seeded 0, as ``dvo_tpu`` seeds
    ``PRNGKey(0)``).  ``mode="rgbd"``: frame-to-frame tracking on measured
    depth.  ``chunk`` > 1: raw uint8/uint16 chunks, registered on the
    device in one batched call per chunk.

    The depth stream is pre-culled by ``2**cfg.pyramid.culls`` through a
    composed undistort-stride map and the device runs with culls=0 (exact:
    the strided depth grid with depth_K / 2**culls projects the same rays).
    ``gray_cull`` pre-culls the color stream (an approximation: registration
    then samples the strided gray with rgb_K / gray_cull); 0 or 1 disables.
    Both are applied alike on the chunked and per-frame paths."""
    if kcalib is None:
        kcalib = KinectCalibration.kinect_v2()
    if cfg is None:
        cfg = DVOConfig.rgbd() if mode == "rgbd" else DVOConfig.monocular()
    device = torch.device(device)
    rgb_map = (build_undistort_map(kcalib.rgb)
               if undistort and kcalib.rgb.distortion is not None else None)
    depth_map = (build_undistort_map(kcalib.depth)
                 if undistort and kcalib.depth.distortion is not None else None)
    items_all = list(sequence)
    gray_cull = max(int(gray_cull), 1)
    dst = 2 ** cfg.pyramid.culls
    if items_all:
        rgb_map = _composed_cull_map(rgb_map, items_all[0].gray_path, gray_cull)
        depth_map = _composed_cull_map(depth_map, items_all[0].depth_path, dst)
    cfg, depth_K = _device_cfg(cfg, kcalib.depth.K, dst, device)
    rgb_K_h = np.asarray(kcalib.rgb.K, np.float32).copy()
    rgb_K_h[:2] /= gray_cull
    rgb_K = torch.tensor(rgb_K_h, device=device)
    invT = torch.tensor(np.asarray(kcalib.invT, np.float32), device=device)

    def register(grays, gmask, depths_raw):
        """Raw frames (or chunks) on the device -> (mapped gray, mapped
        mask, depth [m], sigma): u8 -> [0, 1] and u16 -> metres by the same
        float32 divisions as the host conversion, then the registration."""
        g = grays.to(torch.float32) / 255.0
        d = depths_raw.to(torch.float32) / TUM_DEPTH_SCALE
        mapped, mask, sigma = map_depth_to_gray(d, g, gmask, rgb_K, depth_K, invT)
        return mapped, mask, d, sigma

    items = items_all[:max_frames]
    use_chunk = bool(chunk and chunk > 1) and len(items) > chunk
    loaders: list = []
    try:
        # Both paths decode through the same streams at raw scale.
        gray_stream = _image_stream([it.gray_path for it in items], 1.0, rgb_map, loaders)
        depth_stream = _image_stream([it.depth_path for it in items], 1.0, depth_map, loaders)

        def prep_raw():
            gray, gmask = next(gray_stream)
            depth, _ = next(depth_stream)
            return gray, gmask, depth

        def prep():
            """The next frame registered on the device (the float32 counts
            convert exactly as uint16 would)."""
            gray, gmask, depth = prep_raw()
            if use_chunk:   # quantise as the chunk rows are
                gray = quantize(gray)
            g, m, d = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in (gray, gmask, depth.astype(np.float32)))
            return register(g, m, d)

        mapped, mask, depth, sigma = prep()
        out = _Trajectory(items, metrics, verbose)
        if mode == "rgbd":
            state = rgbd_init(mapped, mask, depth, sigma, depth_K, cfg, device=device)
        else:
            state = monocular_init_with_depth(
                mapped, mask, depth, sigma, depth_K, cfg, device=device,
                generator=torch.Generator(device=device).manual_seed(0))

        start_fi = 1
        if use_chunk:
            # Frame 1 sizes the staging sets; its mask is the constant
            # undistortion-border mask, staged once.
            pending = [prep_raw()]
            gshape, gmask0, dshape = (pending[0][0].shape, np.asarray(pending[0][1]),
                                      pending[0][2].shape)
            gmask_dev = torch.from_numpy(gmask0).to(device)

            def fill_row(bufs, k):
                g, m, d = pending.pop() if pending else prep_raw()
                _check_mask(m, gmask0)
                bufs[0][k] = np.rint(g)   # fractional luma -> nearest level
                bufs[1][k] = d            # depth counts are exact integers

            def dispatch(bufs):
                nonlocal state
                mapped_c, mask_c, d_c, sigma_c = register(bufs[0], gmask_dev, bufs[1])
                if mode == "rgbd":
                    state, res = rgbd_run(state, mapped_c, mask_c, d_c, sigma_c, depth_K, cfg)
                else:
                    state, res = monocular_run(state, mapped_c, mask_c, depth_K, cfg)
                return res

            staging = _Staging([((chunk,) + gshape, torch.uint8),
                                ((chunk,) + dshape, torch.uint16)], device)
            start_fi = out.chunked(chunk, staging, fill_row, dispatch)

        for fi in range(start_fi, len(items)):
            mapped, mask, depth, sigma = prep()
            if mode == "rgbd":
                state = out.step(fi, rgbd_step, state, mapped, mask, depth, sigma, depth_K, cfg)
            else:
                state = out.step(fi, monocular_step, state, mapped, mask, depth_K, cfg)
    finally:
        _close(loaders)
    return out.result()
