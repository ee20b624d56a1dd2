"""Per-frame metrics and timing — ``dvo_tpu.utils.metrics`` ported.

``MetricsLogger`` writes ``dvo_tpu``'s JSONL records, one object per frame
with the same keys and rounding (residuals, GN iterations, valid-pixel
counts, keyframe events, depth-filter accept/reject, wall time), from host
copies of the port's results; ``Timer`` waits for the card with
``torch.cuda.synchronize`` before its clock stops.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import IO, Optional

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of (frozen) dataclasses and
    tuples, keeping its structure."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t) for t in tree)
    return fn(tree)


def to_numpy(x):
    """A tensor's host copy as numpy; anything else as ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def device_sync(x) -> None:
    """Wait until the device has computed ``x``: ``torch.cuda.synchronize``
    of its device for a CUDA tensor; nothing for a CPU tensor, which is
    ready when the call that made it returns."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def fetch_start(t: torch.Tensor):
    """Start copying ``t`` to the host without blocking: a CUDA tensor goes
    into pinned memory with an event recorded behind the copy (a copy into
    pageable memory would wait for the device).  Returns (host tensor,
    event or None); read the host tensor only after ``fetch_wait``."""
    if not t.is_cuda:
        return t.detach(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def fetch_wait(host: torch.Tensor, done) -> np.ndarray:
    """Wait for ``fetch_start``'s copy, and for nothing enqueued after it;
    returns the host copy as numpy."""
    if done is not None:
        done.synchronize()
    return host.numpy()


def fetch(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy, through pinned memory on CUDA."""
    return fetch_wait(*fetch_start(t))


class Timer:
    """Wall-clock context timer (reference core/timer.hpp).  ``ms`` is valid
    after exit; pass ``sync`` (a tensor) to wait for the device before the
    clock stops."""

    def __init__(self, sync=None):
        self._sync = sync
        self.ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            device_sync(self._sync)
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


class MetricsLogger:
    """JSONL metrics sink; no-op when constructed with path=None.
    ``log_frame(result, seconds, timestamp)`` takes a ``StepResult`` row of
    tensors (on any device) or of numpy arrays; ``log(**kv)`` writes an
    arbitrary record."""

    def __init__(self, path: Optional[str] = None):
        self._fh: Optional[IO] = open(path, "w") if path else None
        self._n = 0

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def log(self, **kv) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(kv) + "\n")
        self._fh.flush()

    def log_frame(self, result, seconds: float, timestamp: float = 0.0) -> None:
        if self._fh is None:   # no device->host copies when nothing is written
            return
        result = tree_map(to_numpy, result)
        tr = result.tracking
        res = tr.residuals
        active = res > 0
        ba_cost = float(result.ba_cost)
        self.log(
            frame=self._n,
            t=float(timestamp),
            ms=round(seconds * 1e3, 3),
            keyframe=bool(result.is_keyframe),
            xi=[round(float(v), 6) for v in result.relative_xi],
            gn_iters=[int(v) for v in tr.iterations],
            final_residual=[
                round(float(res[l][active[l]][-1]), 6) if active[l].any() else None
                for l in range(res.shape[0])
            ],
            valid_pixels=[int(v) for v in tr.valid_counts.max(axis=1)],
            map_observed=int(result.mapping.observed),
            map_accepted=int(result.mapping.accepted),
            map_rejected=int(result.mapping.rejected),
            map_aged_out=int(result.mapping.aged_out),
            ba_cost=round(ba_cost, 6) if ba_cost >= 0 else None,
        )
        self._n += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
