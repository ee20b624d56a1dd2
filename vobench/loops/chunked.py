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

RGB-D runs one stream: ``rgbd_run_raw`` has no stream axis, and a mix
that asks for more is refused rather than run on stream 0 alone.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

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


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device="cuda", setup_clock=None, shape=None) -> Run:
    """The offline loop (module docstring).  ``setup_clock()`` gives the
    seconds since the process started; ``shape`` is for the CPU tests."""
    _check(config, traffic)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = program.dvo_config(config)
    inp = make_inputs(config, traffic, seed, dev, cuda, shape)
    B, n, M = traffic["streams"], traffic["chunk"], traffic["period"]
    if M % n:
        raise ValueError(f"period {M} is not a multiple of the chunk {n}")
    chunks = M // n
    mono = config["mode"] == "mono"
    ic = config["input"]
    # rig frames in chunk order, each chunk one contiguous block to upload
    bank_g = inp.gray.reshape(B, chunks, n, *inp.gray.shape[2:]).transpose(0, 1).contiguous()
    bank_c = None if mono else inp.counts.reshape(B, chunks, n, *inp.counts.shape[2:]) \
        .transpose(0, 1).contiguous()
    if cuda:
        bank_g = bank_g.pin_memory()
        bank_c = None if bank_c is None else bank_c.pin_memory()
    resets = None if not mono else inp.resets.reshape(B, chunks, n, *inp.resets.shape[2:]) \
        .transpose(0, 1).contiguous()

    # the first frame of each stream is the last of its cycle: the path is closed
    first = inp.gray[:, M - 1].to(dev)
    if mono:
        state = program.mono_init(first, inp.mask, inp.K, cfg, inp.noise, dev)
    else:
        state = program.rgbd_init(first[0], inp.mask, inp.counts[0, M - 1].to(dev), inp.K, cfg,
                                  ic["depth_scale"], ic["depth_sigma"])
    start = state

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
    sets = [_drain_buffers(program.fields(res), cuda) for _ in range(3)]
    free = collections.deque(range(3))
    host = collections.defaultdict(list)
    inflight = collections.deque()
    reservoir = Reservoir(traffic["check_chunks"], np.random.default_rng(stream_seed(seed, 1 << 21)))
    count = [2, 0]                     # next chunk, frames on the host

    def retire():
        ev, i, frames = inflight.popleft()
        if ev is not None:
            ev.synchronize()
        for key, buf in sets[i].items():
            host[key].append(buf.numpy().copy())
        free.append(i)
        count[1] += frames

    def enqueue(judged=True):
        nonlocal state
        k = count[0] % chunks
        before = state
        state, res = call(state, k)
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
    t0 = time.perf_counter()
    enqueue()
    while time.perf_counter() - t0 < seconds:
        enqueue()
    drain()
    program.sync(dev)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    return Run(frames=count[1] - before_window, window_s=window, setup_s=setup_s,
               capture_s=walls[0] - walls[1],
               host={k: np.concatenate(v, axis=1 if B > 1 else 0) for k, v in host.items()},
               samples=reservoir.items, first=start, trace=traced, memory_peak_bytes=peak,
               inputs=inp)


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
