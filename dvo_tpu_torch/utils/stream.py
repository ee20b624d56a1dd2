"""Live / streaming mode — ``dvo_tpu.utils.stream.run_stream`` ported
(reference USE_CAMERA, main.cpp:10,26-30).  Frames are consumed one at a
time as the iterable produces them, so an unbounded producer works;
``watch_directory`` is the producer for a directory that a capture tool
(test/record.cpp:21-54: numbered PNGs) fills."""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from dvo_tpu_torch.config import DVOConfig
from dvo_tpu_torch.models.odometry import monocular_init, monocular_step
from dvo_tpu_torch.utils.datasets import build_undistort_map, load_gray_normalized, remap_nearest
from dvo_tpu_torch.utils.metrics import device_sync
from dvo_tpu_torch.utils.runner import decode_route
from dvo_tpu_torch.utils.trajectory import tum_line


def watch_directory(
    path: str,
    suffix: str = ".png",
    poll_s: float = 0.05,
    idle_timeout_s: float = 5.0,
    stop: Optional[Callable[[], bool]] = None,
) -> Iterator[str]:
    """Yield image paths from ``path`` in sorted filename order as they
    appear (the record.cpp numbered-PNG convention sorts correctly).

    A file is yielded once its size is stable across two polls (the
    producer may still be writing it).  The generator ends after
    ``idle_timeout_s`` with no new frames, or when ``stop()`` is truthy.
    """
    seen = set()
    pending: dict = {}
    last_new = time.monotonic()
    while True:
        if stop is not None and stop():
            return
        try:
            names = sorted(os.listdir(path))
        except FileNotFoundError:
            names = []
        for name in names:
            if not name.endswith(suffix) or name in seen:
                continue
            full = os.path.join(path, name)
            try:
                size = os.path.getsize(full)
            except OSError:
                continue
            if pending.get(name) == size:
                seen.add(name)
                del pending[name]
                yield full
                # Restart the idle clock AFTER the consumer returns: time
                # the consumer spends on the frame (the kernels' build, tracking)
                # is not producer idleness.
                last_new = time.monotonic()
            else:
                # First sighting (or still growing) counts as activity:
                # the consumer may hold this generator suspended for longer
                # than idle_timeout_s (e.g. the kernels' build) and must not
                # time out over files that arrived meanwhile.
                pending[name] = size
                last_new = time.monotonic()
        if time.monotonic() - last_new > idle_timeout_s:
            return
        time.sleep(poll_s)


def run_stream(
    frames: Iterable,
    calib,
    cfg: DVOConfig = DVOConfig.monocular(),
    seed: int = 0,
    undistort: bool = True,
    on_pose: Optional[Callable[[int, np.ndarray], None]] = None,
    trajectory_out: Optional[str] = None,
    verbose: bool = False,
    device="cuda",
):
    """Monocular VO over a stream of frames (paths or (H, W) float arrays in
    [0, 1]), per frame — the streaming twin of ``runner.run_monocular`` with
    ``chunk=0``, drawing from a generator seeded ``seed`` on ``device``.

    ``on_pose(i, T_world)`` fires after every frame; ``trajectory_out``
    gets a TUM line per frame as it is produced.  Returns (timestamps,
    poses (N, 4, 4), per-frame seconds)."""
    device = torch.device(device)
    srcmap = (build_undistort_map(calib)
              if undistort and getattr(calib, "distortion", None) is not None else None)
    K = torch.tensor(np.asarray(calib.K, np.float32), device=device)
    native = None
    if decode_route() == "native":
        from dvo_tpu_torch import native

    def prep(frame):
        if isinstance(frame, str):
            gray = (native.decode_png_f32(frame, 1 / 255.0) if native is not None
                    else load_gray_normalized(frame))
        else:
            gray = np.asarray(frame, np.float32)
        if srcmap is None:
            mask = np.ones_like(gray, bool)
        elif native is not None:
            gray, mask = native.remap_nearest(gray, srcmap, border=0.0)
        else:
            gray, mask = remap_nearest(gray, srcmap, border=0.0)
        return torch.from_numpy(gray.astype(np.float32)), torch.from_numpy(mask)

    state = None
    poses, times, secs = [], [], []
    fh = open(trajectory_out, "w") if trajectory_out else None
    try:
        for i, frame in enumerate(frames):
            ts = time.time()
            gray, mask = prep(frame)
            t0 = time.perf_counter()
            if state is None:
                state = monocular_init(gray, mask, K, cfg, device=device,
                                       generator=torch.Generator(device=device).manual_seed(seed))
                T = np.eye(4, dtype=np.float32)
            else:
                state, res = monocular_step(state, gray, mask, K, cfg)
                device_sync(res.T_world)
                T = res.T_world.cpu().numpy()
            secs.append(time.perf_counter() - t0)
            poses.append(T)
            times.append(ts)
            if fh is not None:
                fh.write(tum_line(ts, T) + "\n")
                fh.flush()
            if on_pose is not None:
                on_pose(i, T)
            if verbose:
                print(f"stream frame {i:4d} {secs[-1] * 1e3:7.1f} ms", flush=True)
    finally:
        if fh is not None:
            fh.close()
    return (np.asarray(times), np.stack(poses) if poses else np.zeros((0, 4, 4)),
            np.asarray(secs))
