"""The graphed step driver: the counterpart of ``dvo_tpu``'s compiled
``lax.scan`` chunk (``dvo_tpu/models/odometry.py``: ``monocular_run``
:289-320, ``rgbd_run`` :372-395, and, over B streams,
``monocular_run_batched`` :457-467).

A ``StepDriver`` owns three things:
- static inputs: one frame's input tensors (gray and mask; the reset plane
  when the caller passes the planes; depth and sigma on RGB-D) and ``K``;
- a static state, each pyramid's planes of one kind back to back in one
  buffer (the frame-build kernel's layout);
- one step (``monocular_step`` or ``rgbd_step``) that reads them and ends by
  copying its new state into the static state: one ``torch._foreach_copy_``
  per dtype over the state's buffers (whole plane-kind buffers where both
  sides lie in one), so a frame allocates nothing.

On CUDA the step is captured once in a CUDA graph on the driver's own CUDA
stream, into a memory pool of its own (``_build.capture_graph``); when the
step draws its reset planes, the state's generator is registered with the
graph, so a replay draws what the eager step would.  Per frame, in order and
all on that stream: copy frame i into the inputs, replay, copy the step's
results into row i of the chunk's preallocated result stack.  Nothing is
read back to the host.  A capture that fails raises; nothing runs eager in
its place.  On the CPU the same protocol (load, step, copy back, copy out)
runs without capture.

``run`` drives B streams, one driver each.  On the card the B replays of a
frame are issued one after another, each on its driver's stream, so they
run concurrently; on the CPU the streams run in turn.  The drivers are
cached with the state object they were loaded from and the one they return,
so the runner, which hands each chunk's state to the next, captures once
per stream per run.  A chunk starts by copying its incoming state into the
static one and ends with one copy of the static state out: the returned
state never aliases a buffer that a later replay writes.

Tracing (``utils/trace``): ``run`` opens the spans ``dvo.load``,
``dvo.issue`` (the frames) and ``dvo.unload``, a capture ``dvo.capture``;
the copies are the ``copy`` stage.  The graph captured at set-up holds no
marker.  While markers are on (tracing, one stream), a driver captures a
second, traced copy of its step once, with the stage markers in it, and
replays that copy for as long as tracing stays on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from dvo_tpu_torch.models.frame import Frame, Scene, _one_buffer
from dvo_tpu_torch.utils import trace

PLANES = tuple(f.name for f in dataclasses.fields(Scene) if f.name != "K")


# ------------------------------------------------------------------- trees

def leaves(tree) -> list:
    """Every tensor of a state or result, in field order; generators and
    None are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in leaves(x)]
    return []


def tree_map(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``, in the order of
    ``leaves``; generators and None pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, x) for x in tree)
    return tree


def _views(buf: torch.Tensor, like) -> list:
    out, off = [], 0
    for v in like:
        out.append(buf[off:off + v.numel()].view(v.shape))
        off += v.numel()
    return out


def clone_state(tree):
    """A copy of a state in new tensors; every ``Frame``'s planes of one
    kind lie back to back in one buffer, as the frame-build kernel writes
    them (``frame.select_frame`` then selects a kind with one ``where``)."""
    if isinstance(tree, Frame):
        planes = {}
        for name in PLANES:
            views = [getattr(s, name) for s in tree.scenes]
            if any(v is None for v in views):
                planes[name] = [None if v is None else v.clone() for v in views]
            else:
                planes[name] = _views(torch.cat([v.reshape(-1) for v in views]), views)
        scenes = tuple(Scene(K=s.K.clone(), **{n: planes[n][i] for n in PLANES})
                       for i, s in enumerate(tree.scenes))
        return Frame(scenes=scenes, xi=tree.xi.clone(), relative_xi=tree.relative_xi.clone(),
                     age=tree.age.clone(), frame_id=tree.frame_id.clone())
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: clone_state(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(clone_state(x) for x in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _pairs(dst, src, out: list) -> None:
    if isinstance(dst, Frame):
        for name in PLANES:
            dv = [getattr(s, name) for s in dst.scenes]
            sv = [getattr(s, name) for s in src.scenes]
            if [v is None for v in dv] != [v is None for v in sv]:
                raise ValueError(f"state layout changed: the {name} planes")
            if dv[0] is None:
                continue
            db, sb = _one_buffer(dv), _one_buffer(sv)
            out.extend([(db, sb)] if db is not None and sb is not None else zip(dv, sv))
        out.extend((a.K, b.K) for a, b in zip(dst.scenes, src.scenes))
        out.extend((getattr(dst, n), getattr(src, n))
                   for n in ("xi", "relative_xi", "age", "frame_id"))
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _pairs(getattr(dst, f.name), getattr(src, f.name), out)
    elif isinstance(dst, torch.Tensor):
        out.append((dst, src))
    elif isinstance(dst, tuple):
        if len(dst) != len(src):
            raise ValueError("state layout changed: a tuple's length")
        for a, b in zip(dst, src):
            _pairs(a, b, out)


def state_pairs(dst, src) -> list:
    """(destination, source) for every tensor of two states of one layout:
    the buffers of each plane kind where both lie in one, else level by
    level.  Raises where the two differ in shape or dtype."""
    out = []
    _pairs(dst, src, out)
    for d, s in out:
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"state layout changed: {tuple(d.shape)} {d.dtype} <- "
                             f"{tuple(s.shape)} {s.dtype}")
    return out


def copy_pairs(pairs) -> None:
    """destination <- source for every pair: one ``torch._foreach_copy_``
    per dtype, every source read before any destination is written.  A
    step's new state may hold a tensor of the old one in another place (the
    new reference frame's id is the old frame count, which the copy-back
    also overwrites): such a source is cloned first, since one foreach copy
    on the card writes its tensors in no fixed order."""
    written = {d.untyped_storage().data_ptr() for d, _ in pairs if d.numel()}
    pairs = [(d, s.clone() if s.data_ptr() != d.data_ptr()
              and s.untyped_storage().data_ptr() in written else s) for d, s in pairs]
    groups = {}
    for d, s in pairs:
        if d.numel():
            dst, src = groups.setdefault(d.dtype, ([], []))
            dst.append(d)
            src.append(s)
    for dst, src in groups.values():
        torch._foreach_copy_(dst, src)


# ----------------------------------------------------------------- driver

class ResultStack:
    """A chunk's results with a leading ``lead`` shape ((B, N)) on every
    field, allocated once and filled row by row."""

    def __init__(self, lead):
        self.lead = tuple(lead)
        self.template = None
        self.stacks = None

    def allocate(self, template) -> None:
        self.template = template
        self.stacks = [torch.empty(self.lead + tuple(t.shape), dtype=t.dtype, device=t.device)
                       for t in leaves(template)]

    def put(self, row, result) -> None:
        if self.stacks is None:
            self.allocate(result)
        copy_pairs([(s[row], t) for s, t in zip(self.stacks, leaves(result))])

    def tree(self):
        it = iter(self.stacks)
        return tree_map(lambda _: next(it), self.template)


class StepDriver:
    """One stream's step (module docstring).  ``step(state, inputs, K)``
    runs one frame and returns (state', result); ``inputs`` are the first
    frame's input tensors (the static inputs start as copies of them);
    ``generator`` is the generator the step draws from, when it draws."""

    def __init__(self, step, state, inputs, K, key, generator=None):
        self.key, self.generator = key, generator
        self.cuda = K.device.type == "cuda"
        self.state = clone_state(state)
        self.inputs = [x.clone() for x in inputs]
        self.K = K.clone()
        self._step = step
        self.stream = self.out = self._traced = None
        if self.cuda:
            self.stream = torch.cuda.Stream(K.device)
            with trace.span("capture"), trace.unmarked():
                self.out, self._replay = self._capture(warmup=2)

    def _capture(self, warmup: int):
        from dvo_tpu_torch.ops.cuda import _build

        out, replay, _ = _build.capture_graph(
            self._body, warmup=warmup, stream=self.stream, keep=leaves(self.state),
            generators=() if self.generator is None else (self.generator,))
        return out, replay

    def traced(self):
        """(outputs, replay) of the traced copy of the step: captured at
        the first call, with no warm-up, while markers are on."""
        if self._traced is None:
            with trace.span("capture"):
                self._traced = self._capture(warmup=0)
        return self._traced

    def _body(self):
        new, result = self._step(self.state, self.inputs, self.K)
        with trace.stage("copy", end=True):
            copy_pairs(state_pairs(self.state, new))
        return result

    def on_stream(self):
        """The context that runs work on this driver's CUDA stream."""
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def load(self, state, K, sources) -> None:
        """Start a chunk from ``state``: copy it, ``K`` and the chunk-wide
        inputs (``sources``: (tensor, per_frame) aligned with the inputs)."""
        with trace.stage("copy", end=True):
            copy_pairs(state_pairs(self.state, state) + [(self.K, K)]
                       + [(x, t) for x, (t, per_frame) in zip(self.inputs, sources)
                          if not per_frame])

    def frame(self, sources, i: int, results: ResultStack, row, traced: bool = False) -> None:
        """Frame ``i`` of the chunk: its inputs in, one step (the traced
        copy's replay with ``traced``), its results into ``results`` at
        ``row``."""
        with trace.stage("copy", end=True):
            copy_pairs([(x, t[i]) for x, (t, per_frame) in zip(self.inputs, sources)
                        if per_frame])
        if self.cuda:
            result, replay = self.traced() if traced else (self.out, self._replay)
            replay()
        else:
            result = self._body()
        with trace.stage("copy", end=True):
            results.put(row, result)


# Drivers by the id of the state object they were loaded from or returned
# (a weak reference checks that the object is still the one registered).
_REGISTRY: dict = {}


def drivers_of(owner):
    """The drivers cached with a state object (None: none)."""
    entry = _REGISTRY.get(id(owner))
    return entry[1] if entry is not None and entry[0]() is owner else None


def register(owner, drivers) -> None:
    """Cache ``drivers`` with the state object ``owner``: ``run`` registers
    the state it was given, its caller the state it returns."""
    key = id(owner)

    def drop(ref, key=key):
        if _REGISTRY.get(key, (None,))[0] is ref:
            del _REGISTRY[key]

    _REGISTRY[key] = (weakref.ref(owner, drop), drivers)


def carry(new, old) -> None:
    """Let ``new`` (a state derived from ``old`` on the host, say a
    pose-graph correction) reuse ``old``'s drivers: its next chunk loads it
    into them instead of capturing again."""
    drivers = drivers_of(old)
    if drivers is not None:
        register(new, drivers)


def run(owner, states, step, key, Ks, sources, n: int, generators=None):
    """``n`` frames of B streams.  ``owner``: the state object the caller
    passed (a single state, or a stack of B), with which the drivers are
    cached; ``states``: the B per-stream states; ``step``: as
    ``StepDriver``'s; ``key``: what the captured step depends on besides
    the generator (the drivers cached with ``owner`` are reused when it
    matches); ``Ks``: B (3, 3) intrinsics; ``sources``: per stream, the
    step's inputs as (tensor, per_frame), an (n, ...) stack where per_frame
    holds, else one tensor for the chunk; ``generators``: per stream, the
    generator the step draws from (None: it draws nothing).  Returns (the
    B states', the results with a leading (B, n) axis, the drivers, which
    the caller ``register``s with the state it returns)."""
    b_count = len(states)
    gens = [None] * b_count if generators is None else list(generators)
    cached = drivers_of(owner)
    drivers = []
    for b in range(b_count):
        d = cached[b] if cached is not None and len(cached) == b_count else None
        if d is None or d.key != key or d.generator is not gens[b]:
            first = [t[0] if per_frame else t for t, per_frame in sources[b]]
            d = StepDriver(step, states[b], first, Ks[b], key, gens[b])
        drivers.append(d)
    drivers = tuple(drivers)
    register(owner, drivers)
    traced = trace.marking() and drivers[0].cuda
    if traced:
        drivers[0].traced()
    results = ResultStack((b_count, n))
    caller = None
    if drivers[0].cuda:
        caller = torch.cuda.current_stream(Ks[0].device)
        results.allocate(drivers[0].out)
    with trace.span("load"):
        for b, d in enumerate(drivers):
            if caller is not None:
                d.stream.wait_stream(caller)
            with d.on_stream():
                d.load(states[b], Ks[b], sources[b])
    with trace.span("issue"):
        for i in range(n):
            for b, d in enumerate(drivers):
                with d.on_stream():
                    d.frame(sources[b], i, results, (b, i), traced)
    if caller is not None:
        for d in drivers:
            caller.wait_stream(d.stream)
    with trace.span("unload"), trace.stage("copy", end=True):
        out = [clone_state(d.state) for d in drivers]
    return out, results.tree(), drivers
