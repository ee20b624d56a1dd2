"""The host's side of a run: where the process runs, and what the host did
while the window ran.

Two of the cells are bound by the host's issue of work to the card, so a
run's rate follows the speed of the CPU that issues it.  ``place`` puts the
process on the CPUs local to the card (the NUMA node the card hangs off,
as ``numactl --cpunodebind`` places a GPU deployment), and ``report``
prints on standard error what a run's rate should be read beside: the
placement, the CPU and the card's clocks, the set-up's parts, the wall of
every chunk of the window with the CPU its issue thread was on and the
host time of its program call, the CPU time of each thread in the window,
and the host's speed at Python just before and just after the window.
None of it reaches the result line.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SYSFS_PCI = Path("/sys/bus/pci/devices")
SMI_FIELDS = ("name", "clocks.sm", "clocks.max.sm", "clocks.mem", "power.limit", "power.draw",
              "temperature.gpu", "pstate")


def parse_cpulist(text: str) -> set:
    """The CPUs of a kernel cpulist (``0-3,8,10-11``) as a set."""
    cpus = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def cpulist(cpus) -> str:
    """A set of CPUs written as a kernel cpulist (the inverse of ``parse_cpulist``)."""
    spans = []
    for c in sorted(cpus):
        if spans and c == spans[-1][1] + 1:
            spans[-1][1] = c
        else:
            spans.append([c, c])
    return ",".join(f"{a}-{b}" if b > a else f"{a}" for a, b in spans)


def card_bus_id(index: int = 0):
    """The PCI address of CUDA device ``index`` as sysfs writes it
    (``0000:5d:00.0``), or None where torch does not give it."""
    import torch

    p = torch.cuda.get_device_properties(index)
    try:
        return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
    except AttributeError:
        return None


def _threads() -> list:
    return [int(t) for t in os.listdir("/proc/self/task")]


def place(bus_id, sysfs: Path = SYSFS_PCI) -> dict:
    """Put every thread of the process on the card's local CPUs that it
    may use (``local_cpulist`` of the card's PCI device, intersected with
    the allowed set); threads started later inherit it.  Where the file is
    missing or the intersection is empty, the placement stays as it was.
    Returns what was read and done, for ``report``."""
    allowed = os.sched_getaffinity(0)
    rec = {"bus_id": bus_id, "allowed": cpulist(allowed), "numa_node": None,
           "local_cpulist": None, "cpus": cpulist(allowed), "placed": False}
    if not bus_id:
        rec["why"] = "no PCI address for the card: left as it was"
        return rec
    try:
        local = parse_cpulist((sysfs / bus_id / "local_cpulist").read_text())
        rec["local_cpulist"] = cpulist(local)
        rec["numa_node"] = int((sysfs / bus_id / "numa_node").read_text())
    except (OSError, ValueError) as e:
        rec["why"] = f"no local_cpulist for the card ({type(e).__name__}): left as it was"
        return rec
    both = local & allowed
    if not both:
        rec["why"] = "the card's local CPUs and the allowed ones do not meet: left as it was"
        return rec
    try:
        os.sched_setaffinity(0, both)
    except OSError as e:
        rec["why"] = f"the placement was refused ({e}): left as it was"
        return rec
    for tid in _threads():
        try:
            os.sched_setaffinity(tid, both)
        except ProcessLookupError:      # a thread that ended meanwhile
            pass
    rec.update(cpus=cpulist(both), placed=True)
    return rec


def cpu_reader():
    """A function giving the CPU the calling thread runs on: libc's
    ``sched_getcpu``, the number field 39 of ``/proc/thread-self/stat``
    holds, without reading a file."""
    f = ctypes.CDLL(None).sched_getcpu
    f.restype, f.argtypes = ctypes.c_int, []
    return f


def thread_ticks() -> dict:
    """{thread id: (name, user and system clock ticks)} of the process's threads."""
    out = {}
    for tid in _threads():
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                name, rest = f.read().rsplit(")", 1)
        except OSError:                 # a thread that ended meanwhile
            continue
        fields = rest.split()
        out[tid] = (name.split("(", 1)[1], int(fields[11]) + int(fields[12]))
    return out


def thread_seconds(before: dict, after: dict) -> list:
    """[(name/id, CPU seconds)] of each thread between two ``thread_ticks``,
    the busiest first."""
    tick = os.sysconf("SC_CLK_TCK")
    used = [(f"{name}/{tid}", (t - before.get(tid, (name, 0))[1]) / tick)
            for tid, (name, t) in after.items()]
    return sorted((u for u in used if u[1] > 0), key=lambda u: -u[1])


def cpu_probe(n: int = 100_000, repeats: int = 5) -> float:
    """The host's speed at Python now: the least ns an iteration of a fixed
    loop took over ``repeats`` timings of ``n`` iterations (~50 ms in all)."""
    best = float("inf")
    for _ in range(repeats):
        t, x = time.perf_counter(), 0
        for i in range(n):
            x += i & 7
        best = min(best, time.perf_counter() - t)
    return 1e9 * best / n


def cpu_model() -> tuple:
    """The distinct model names and MHz of ``/proc/cpuinfo``."""
    names, mhz = set(), set()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "model name":
                    names.add(value.strip())
                elif key.strip() == "cpu MHz":
                    mhz.add(value.strip())
    except OSError:
        pass
    return sorted(names), sorted(mhz)


def card_readings() -> str:
    """``nvidia-smi``'s clocks, power and temperature of the cards, as its
    CSV, or why there are none."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"no nvidia-smi reading ({type(e).__name__})"
    return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()


def chunk_walls(marks: list, t0: float) -> list:
    """The us from one retire to the next (from ``t0`` to the first) of
    the retire times ``marks``."""
    return [int(round(1e6 * (t - prev))) for prev, t in zip([t0] + marks, marks)]


def runs(values) -> str:
    """``values`` run-length coded: ``3x120 5x7`` is 3 taken 120 times, then 5."""
    out = []
    for v in values:
        if out and out[-1][0] == v:
            out[-1][1] += 1
        else:
            out.append([v, 1])
    return " ".join(f"{v}x{n}" for v, n in out)


def report(run, placement: dict, out=None) -> None:
    """Print a run's host readings (``run.readings``, filled by its loop)
    on ``out``, standard error by default: lines that start ``vobench: host``."""
    import torch

    out = out or sys.stderr

    def say(*words):
        print("vobench: host", *words, file=out)

    p, r = placement, run.readings
    say(f"placement placed={p['placed']} card={p['bus_id']} numa_node={p['numa_node']} "
        f"local_cpulist={p['local_cpulist']} allowed={p['allowed']} cpus={p['cpus']}"
        + (f" ({p['why']})" if "why" in p else ""))
    names, mhz = cpu_model()
    say(f"cpu model={names} mhz={mhz} torch_threads={torch.get_num_threads()}")
    say(f"card {card_readings()}")
    ends = [0.0] + [at for _, at in r["setup_parts"]]
    say("setup_parts_s " + " ".join(f"{name}={b - a:.3f}" for (name, _), a, b
                                    in zip(r["setup_parts"], ends, ends[1:]))
        + f" total={run.setup_s:.3f}")
    walls = r["chunk_walls"]
    if walls:
        med = statistics.median(walls)
        long = [w for w in walls if w > 2 * med]
        q = statistics.quantiles(walls, n=10) if len(walls) > 1 else [walls[0]] * 9
        say(f"window frames={run.frames} s={run.window_s:.4f} "
            f"frames_per_s={run.frames / run.window_s:.2f} chunks={len(walls)} "
            f"wall_us median={med} p10={q[0]:.0f} p90={q[8]:.0f} max={max(walls)} "
            f"over_2x_median={len(long)} their_share={sum(long) / sum(walls):.4f}")
    parts = {"call": sum(r["chunk_calls"]) * 1e-6, **r["chunk_parts"]}
    say("window " + " ".join(f"{k}_s={v:.4f}" for k, v in parts.items()))
    say(f"chunk_wall_us {' '.join(map(str, walls))}")
    say(f"chunk_call_us {' '.join(map(str, r['chunk_calls']))}")
    say(f"chunk_cpu {runs(r['chunk_cpus'])}")
    say("thread_cpu_s " + " ".join(f"{n}={s:.2f}" for n, s in r["thread_cpu_s"][:12]))
    say("cpu_probe_ns before={:.2f} after={:.2f}".format(*r["cpu_probe_ns"]))
