"""The port's tracing: host spans and device stage markers, recorded into
``torch.profiler``'s own trace, where the host's and the card's events share
one clock.  Nothing is exported apart: ``run.py --trace`` writes the
profiler's Chrome trace, and the benchmark reads the same events.

One switch: tracing is on exactly while a profiler records
(``torch._C._autograd._profiler_enabled()``).  While it is off, ``span``,
``stage``, ``chunk`` and ``unmarked`` check that one flag and return one
shared no-op context (``OFF``): they build nothing and call nothing else.

- ``span(name)``: a host range ``dvo.<name>`` at a boundary of the graphed
  path or the runner, once a chunk and never a frame (``dvo.chunk``,
  ``dvo.cull``, ``dvo.capture``, ``dvo.load``, ``dvo.issue``,
  ``dvo.unload``; the runner's ``dvo.fill``, ``dvo.upload``,
  ``dvo.dispatch``, ``dvo.drain``).
- ``stage(name)``: a host range ``dvo.stage.<name>`` around a stage of the
  step (``STAGES``) and, while markers are on, an empty marker kernel
  ``dvo_stage_<name>`` (``csrc/stage.cu``) enqueued where the stage begins.
  A stage's device region runs from its marker to the next marker, so a
  nested stage marks its parent again when it ends; ``end=True`` enqueues
  the ``dvo_stage_end`` marker instead, after which the card's time belongs
  to no stage (a launch gap, the caller's own work).
- ``chunk(streams, device)``: the ``dvo.chunk`` span of an entry point.
  Markers are on inside it when one stream runs on a CUDA device: B
  streams replay on B CUDA streams at once, and the profiler's device
  events carry no stream to split their time by.

The ranges are FUNCTION-scoped ``torch.profiler`` ranges: a user-scoped
range (``record_function``) also puts a span on the card's timeline,
which would count among the device's operations and fill its idle gaps.
The markers launch through the kernel library but are not counted in
``_build.LAUNCHES``.
"""

from __future__ import annotations

import threading

import torch

from dvo_tpu_torch.ops.cuda import _build

# csrc/stage.cu's markers, in its order; the last ends a region.
MARKERS = ("frame_build", "track", "pose", "map", "copy", "end")
STAGES = MARKERS[:-1]
_INDEX = {name: i for i, name in enumerate(MARKERS)}

_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Off:
    """The shared no-op context."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Local(threading.local):
    def __init__(self):
        self.marking = False      # markers on (a one-stream chunk on a CUDA device)
        self.open = []            # the stages open, innermost last


_local = _Local()


def marking() -> bool:
    """Whether stages enqueue their markers here: tracing is on inside a
    one-stream chunk on a CUDA device."""
    return _local.marking and _recording()


def _can_mark(device) -> bool:
    return torch.device(device).type == "cuda"


def _load() -> None:
    _build.check(_build.library().dvo_stage_load(), "dvo_stage_load")


def _launch(index: int) -> None:
    lib = _build.library()
    _build.check(lib.dvo_stage_mark(index, torch.cuda.current_stream().cuda_stream),
                 f"dvo_stage_{MARKERS[index]}")


def _mark(name: str) -> None:
    if _local.marking:
        _launch(_INDEX[name])


def span(name: str):
    """The host range ``dvo.<name>``."""
    if not _recording():
        return OFF
    return _Range("dvo." + name)


class _Stage:
    __slots__ = ("name", "end", "range")

    def __init__(self, name: str, end: bool):
        self.name, self.end = name, end
        self.range = _Range("dvo.stage." + name)

    def __enter__(self):
        self.range.__enter__()
        _local.open.append(self.name)
        _mark(self.name)

    def __exit__(self, *exc):
        _local.open.pop()
        if self.end:
            _mark("end")
        elif _local.open:
            _mark(_local.open[-1])
        return self.range.__exit__(*exc)


def stage(name: str, end: bool = False):
    """The stage ``name`` of the step (module docstring)."""
    if not _recording():
        return OFF
    if name not in STAGES:
        raise ValueError(f"no stage {name!r}: one of {STAGES}")
    return _Stage(name, end)


class _Marking:
    """Markers on or off inside the block; what was open outside is
    restored after it."""

    __slots__ = ("on", "range", "saved")

    def __init__(self, on: bool, range_=None):
        self.on, self.range, self.saved = on, range_, None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        self.saved = _local.marking, _local.open
        _local.marking, _local.open = self.on, []
        if self.on:
            _load()

    def __exit__(self, *exc):
        _local.marking, _local.open = self.saved
        if self.range is not None:
            return self.range.__exit__(*exc)
        return False


def chunk(streams: int, device):
    """The ``dvo.chunk`` span of an entry point running ``streams`` streams
    on ``device``; markers are on inside it for one stream on a CUDA
    device."""
    if not _recording():
        return OFF
    return _Marking(streams == 1 and _can_mark(device), _Range("dvo.chunk"))


def unmarked():
    """Markers off inside the block: what is captured there replays with
    tracing off and gains no marker."""
    if not _recording():
        return OFF
    return _Marking(False)
