"""Reading a ``torch.profiler`` window: device intervals, ops by name, the
busy time as the union of the device's intervals, and the breakdown of the
result line.

The arithmetic follows the port's bring-up check (``chip_smoke.py``'s
``device_profile``): device events are the CUDA-side ones (kernels, copies,
memsets); an op's count per frame is its events over the frames, so a lost
event moves a count by a fraction and no more.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Trace:
    """One traced window: device events (name, start us, end us), host op
    events (name, start us, end us), the window's host wall and the frames
    it carried."""
    device: list
    host: list
    window_s: float
    frames: int
    first: int = 0        # index of the first traced frame among the window's frames

    def union_s(self) -> float:
        """Seconds in which any device operation ran (overlaps counted once)."""
        total, end = 0.0, None
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-6

    def by_name(self) -> dict:
        """{name: (events, summed us)} of the device events."""
        out = {}
        for name, s, e in self.device:
            n, t = out.get(name, (0, 0.0))
            out[name] = (n + 1, t + (e - s))
        return out

    def matching(self, words) -> list:
        """Device events whose name holds one of ``words``."""
        return [ev for ev in self.device if any(w in ev[0] for w in words)]

    def gaps(self, top: int = 10) -> list:
        """The ``top`` longest gaps between device intervals, each as [what
        the host was doing (the innermost host op covering the gap's
        start), seconds]."""
        spans, end = [], None
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            if end is not None and s > end:
                spans.append((end, s))
            end = e if end is None else max(end, e)
        spans.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in spans[:top]:
            covering = [h for h in self.host if h[1] <= a < h[2]]
            name = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "no host op"
            out.append([name, (b - a) * 1e-6])
        return out

    def top_ops(self, top: int = 10) -> list:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:top]
        return [[name, t * 1e-6] for name, (_, t) in ops]


def profiled(run, frames: int):
    """Run ``run()`` (which enqueues ``frames`` frames and synchronises)
    under ``torch.profiler`` with CPU and CUDA activity.  Returns a
    ``Trace``, or None when the profiler showed no device event."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    if not device:
        return None
    return Trace(device, host, wall, frames)
