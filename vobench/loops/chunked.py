"""The offline loop, the one general generator of chunked traffic: it reads
a mix (``streams``, ``chunk``, ``period``, ``check_chunks``,
``check_track_every``, ``trace_chunks``) and a configuration, and drives
the program's graphed driver with them.

``streams`` cameras, each with its own rig, are handed over ``chunk``
frames at a time from pinned host memory, as the offline runner does;
closed loop with at most two chunks in flight.  The frames of a stream
repeat every ``period`` frames (the rig's closed path).  The set-up warms
every shape the window uses; with ``trace`` a profiled part of
``trace_chunks`` chunks runs next, outside the window; the window runs
``seconds`` and then drains.  A sample of ``check_chunks`` chunks, drawn
from the seed, keeps the program's state before and after each for the
judge.

A retire copies the chunk's outputs into host arrays allocated ahead
(``Drained``), so that the harness's own work between the program's calls
stays small.  For standard error (``vobench/host.py``) a run also keeps
the times of the set-up's parts, the time and CPU of each of the window's
retires, the host time of each chunk's program call, the window's host
time by part (the program's calls; the result copies with the event and
the judge's sample; the waits on the card; the drain into host arrays),
each thread's CPU time in the window, and a fixed piece of Python timed
just before the window and just after it (counted in neither).

RGB-D runs one stream: ``rgbd_run_raw`` has no stream axis, and a mix
that asks for more is refused rather than run on stream 0 alone.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from vobench import host as hostinfo
from vobench import program
from vobench.drivers import Reservoir, Run, Sample, make_inputs, stream_seed
from vobench.judge import (Readings, control_mono, control_rgbd, frame, judge_mono_frames,
                           judge_rgbd_frames, mono_state, precision, start_gap_frame,
                           start_gap_mono)
from vobench.profiling import profiled
from vobench.reference import dvo

TRACE_TRIES = 3


def _check(config: dict, traffic: dict) -> None:
    if config["mode"] == "rgbd" and traffic["streams"] != 1:
        raise ValueError(f"the chunked loop drives one RGB-D stream, not {traffic['streams']}: "
                         "the program's rgbd_run_raw has no stream axis")


def _drain_buffers(outputs: dict, pinned: bool) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pinned) for k, v in outputs.items()}


class Drained:
    """The outputs of every retired chunk on the host, in order: a retire
    copies the chunk's drain buffers (numpy views shaped as ``like``) into
    the next slot of blocks allocated ``block`` chunks at a time, so that it
    allocates nothing else."""

    def __init__(self, like: dict, block: int = 512):
        self.like = like
        self.block, self.blocks, self.count = block, [], 0

    def put(self, views: dict) -> None:
        j = self.count % self.block
        if j == 0:
            self.blocks.append({k: np.empty((self.block,) + v.shape, v.dtype)
                                for k, v in self.like.items()})
        last = self.blocks[-1]
        for key, v in views.items():
            last[key][j] = v
        self.count += 1

    def arrays(self, batched: bool) -> dict:
        """{key: the chunks' frames back to back}: (B, frames, ...) for
        ``batched`` outputs (B, n, ...), else (frames, ...)."""
        out = {}
        for key, v in self.like.items():
            slots = np.concatenate([b[key] for b in self.blocks])[:self.count] if self.blocks \
                else np.empty((0,) + v.shape, v.dtype)
            if batched:
                slots = np.moveaxis(slots, 0, 1)
                out[key] = slots.reshape(slots.shape[0], -1, *slots.shape[3:])
            else:
                out[key] = slots.reshape(-1, *slots.shape[2:])
        return out


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device="cuda", setup_clock=None, shape=None) -> Run:
    """The offline loop (module docstring).  ``setup_clock()`` gives the
    seconds since the process started; ``shape`` is for the CPU tests."""
    _check(config, traffic)
    parts = []
    mark = (lambda name: parts.append((name, setup_clock()))) if setup_clock else \
        (lambda name: None)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = program.dvo_config(config)
    inp = make_inputs(config, traffic, seed, dev, shape)
    B, n, M = traffic["streams"], traffic["chunk"], traffic["period"]
    if M % n:
        raise ValueError(f"period {M} is not a multiple of the chunk {n}")
    chunks = M // n
    mono = config["mode"] == "mono"
    ic = config["input"]

    def in_chunks(frames):
        """(B, M, ...) host frames in chunk order (chunks, B, n, ...), each
        chunk one contiguous block to upload, copied once into pinned memory
        on the card."""
        src = frames.reshape(B, chunks, n, *frames.shape[2:]).transpose(0, 1)
        return torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda).copy_(src)

    bank_g = in_chunks(inp.gray)
    bank_c = None if mono else in_chunks(inp.counts)
    resets = None if not mono else inp.resets.reshape(B, chunks, n, *inp.resets.shape[2:]) \
        .transpose(0, 1).contiguous()
    program.sync(dev)
    mark("inputs")

    # the first frame of each stream is the last of its cycle: the path is closed
    first = inp.gray[:, M - 1].to(dev)
    if mono:
        state = program.mono_init(first, inp.mask, inp.K, cfg, inp.noise, dev)
    else:
        state = program.rgbd_init(first[0], inp.mask, inp.counts[0, M - 1].to(dev), inp.K, cfg,
                                  ic["depth_scale"], ic["depth_sigma"])
    start = state
    program.sync(dev)
    mark("init")

    def call(state, k):
        g = bank_g[k].to(dev, non_blocking=True)
        if mono:
            return program.mono_chunk(state, g, inp.mask, inp.K, cfg, resets[k])
        c = bank_c[k].to(dev, non_blocking=True)
        return program.rgbd_chunk(state, g[0], inp.mask, c[0], inp.K, cfg,
                                  ic["depth_scale"], ic["depth_sigma"])

    # set-up: the first call captures the step, the second is steady
    walls = []
    for k in range(2):
        t = time.perf_counter()
        state, res = call(state, k)
        program.sync(dev)
        walls.append(time.perf_counter() - t)
        mark(("capture", "steady")[k])
    sets = [_drain_buffers(program.fields(res), cuda) for _ in range(3)]
    views = [{k: b.numpy() for k, b in s.items()} for s in sets]
    drained = Drained(views[0])
    free = collections.deque(range(3))
    inflight = collections.deque()
    reservoir = Reservoir(traffic["check_chunks"], np.random.default_rng(stream_seed(seed, 1 << 21)))
    count = [2, 0]                     # next chunk, frames on the host
    cpu_now = hostinfo.cpu_reader()
    marks, cpus, calls = [], [], []    # each retire's time and CPU, each call's host us
    spent = dict.fromkeys(("result_copies", "wait", "drain"), 0.0)
    clock = time.perf_counter

    def retire():
        ev, i, frames = inflight.popleft()
        t = clock()
        if ev is not None:
            ev.synchronize()
        t1 = clock()
        drained.put(views[i])
        free.append(i)
        count[1] += frames
        t2 = clock()
        spent["wait"] += t1 - t
        spent["drain"] += t2 - t1
        marks.append(t2)
        cpus.append(cpu_now())

    def enqueue(judged=True):
        nonlocal state
        k = count[0] % chunks
        before = state
        t0 = clock()
        state, res = call(state, k)
        t1 = clock()
        out = program.fields(res)
        i = free.popleft()
        for key, t in out.items():
            sets[i][key].copy_(t, non_blocking=True)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        inflight.append((ev, i, B * n))
        if judged:
            reservoir.offer(lambda: Sample(k, before, state, out))
        count[0] += 1
        calls.append(int(round(1e6 * (t1 - t0))))
        spent["result_copies"] += clock() - t1
        if len(inflight) >= 2:
            retire()

    def drain():
        while inflight:
            retire()

    program.sync(dev)
    setup_s = setup_clock() if setup_clock else 0.0
    traced = None
    if trace:
        # the profiled part runs before the window, which stays untraced
        for _ in range(TRACE_TRIES):
            def part():
                for _ in range(traffic["trace_chunks"]):
                    enqueue(judged=False)
                drain()
            first_traced = count[1] // B
            traced = profiled(part, traffic["trace_chunks"] * B * n)
            if traced is not None:
                traced.first = first_traced
                break
    before_window = count[1]
    probe = hostinfo.cpu_probe()
    ticks = hostinfo.thread_ticks()
    del marks[:], cpus[:], calls[:]
    spent.update(dict.fromkeys(spent, 0.0))
    t0 = time.perf_counter()
    enqueue()
    while time.perf_counter() - t0 < seconds:
        enqueue()
    drain()
    program.sync(dev)
    window = time.perf_counter() - t0
    readings = {"setup_parts": parts, "chunk_walls": hostinfo.chunk_walls(marks, t0),
                "chunk_cpus": cpus, "chunk_calls": calls, "chunk_parts": dict(spent),
                "thread_cpu_s": hostinfo.thread_seconds(ticks, hostinfo.thread_ticks()),
                "cpu_probe_ns": (probe, hostinfo.cpu_probe())}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    return Run(frames=count[1] - before_window, window_s=window, setup_s=setup_s,
               capture_s=walls[0] - walls[1], host=drained.arrays(B > 1),
               samples=reservoir.items, first=start, trace=traced, memory_peak_bytes=peak,
               inputs=inp, readings=readings)


def _frame_outputs(outputs: dict, b, i) -> dict:
    return {k: (v[b, i] if b is not None else v[i]) for k, v in outputs.items()}


def _rgbd_frame(config: dict, inp, index: int, cfg) -> dvo.Frame:
    ic = config["input"]
    dev = inp.K.device
    return dvo.rgbd_frame(inp.gray[0, index].to(dev), inp.mask, inp.counts[0, index].to(dev),
                          inp.K, cfg, 0, ic["depth_scale"], ic["depth_sigma"])


def judge(config: dict, traffic: dict, run: Run, control: bool = False) -> Readings:
    """Every number over the run's judged chunks, every stream of each: the
    program's outputs, or with ``control`` the reference's own in TF32 in
    the program's place (``vobench/judge.py``)."""
    _check(config, traffic)
    cfg = dvo.namespace(config["dvo"])
    inp = run.inputs
    dev = inp.K.device
    B, n, M = traffic["streams"], traffic["chunk"], traffic["period"]
    r = Readings()
    with precision(False):
        if config["mode"] == "mono":
            for b in range(B):
                want = dvo.mono_init(inp.gray[b, M - 1].to(dev), inp.mask, inp.K, cfg,
                                     inp.noise[b])
                r.worst("start_gap", start_gap_mono(mono_state(run.first,
                                                               b if B > 1 else None), want))
        else:
            r.worst("start_gap", start_gap_frame(frame(run.first.ref),
                                                 _rgbd_frame(config, inp, M - 1, cfg)))
        for s in run.samples:
            first = s.chunk * n
            if config["mode"] == "mono":
                for b in range(B):
                    bb = b if B > 1 else None
                    st = mono_state(s.before, bb)
                    frames = [(inp.gray[b, first + i].to(dev), inp.resets[b, first + i])
                              for i in range(n)]
                    if control:
                        with precision(True):
                            outs, after = control_mono(st, frames, cfg, inp.mask, inp.K)
                    else:
                        outs = [_frame_outputs(s.outputs, bb, i) for i in range(n)]
                        after = mono_state(s.after, bb)
                    judge_mono_frames(st, frames, outs, after, cfg, inp.mask, inp.K, r,
                                      traffic.get("check_track_every", 1))
            else:
                prev = _rgbd_frame(config, inp, (first - 1) % M, cfg)
                frames = [_rgbd_frame(config, inp, first + i, cfg) for i in range(n)]
                world, vel = s.before.ref.xi, s.before.vel
                if control:
                    with precision(True):
                        outs = control_rgbd(prev, world, vel, frames, cfg)
                else:
                    outs = [_frame_outputs(s.outputs, None, i) for i in range(n)]
                judge_rgbd_frames(prev, world, vel, frames, outs, cfg, r)
    return r
