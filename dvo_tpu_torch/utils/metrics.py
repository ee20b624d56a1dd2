"""Per-frame metrics and timing — ``dvo_tpu.utils.metrics`` ported.

``MetricsLogger`` writes ``dvo_tpu``'s JSONL records (the same keys and
rounding: it is that logger, fed host copies of the port's results).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from dvo_tpu.utils.metrics import MetricsLogger as _ReferenceLogger


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


class MetricsLogger(_ReferenceLogger):
    """JSONL metrics sink; no-op when constructed with path=None.
    ``log_frame(result, seconds, timestamp)`` takes a ``StepResult`` row of
    tensors (on any device) or of numpy arrays."""

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def log_frame(self, result, seconds: float, timestamp: float = 0.0) -> None:
        if self.enabled:   # no device->host copies when nothing is written
            super().log_frame(tree_map(to_numpy, result), seconds, timestamp)
