"""The host readings and the placement (``vobench/host.py``): the card's
``local_cpulist`` is parsed and met with the allowed CPUs, placement is
left as it was where that cannot be done, and a whole run on the CPU keeps
its per-chunk series and prints them on standard error, never in the
result line."""

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from vobench import harness, host

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
BUS = "0000:19:00.0"


@pytest.mark.parametrize("text, cpus", [
    ("0-3,8,10-11", {0, 1, 2, 3, 8, 10, 11}),
    ("0-3,8,10-11\n", {0, 1, 2, 3, 8, 10, 11}),
    ("5", {5}),
    ("0-1,64-65", {0, 1, 64, 65}),
    ("\n", set()),
])
def test_cpulist_forms(text, cpus):
    assert host.parse_cpulist(text) == cpus
    assert host.parse_cpulist(host.cpulist(cpus)) == cpus


def test_cpulist_is_written_in_ranges():
    assert host.cpulist({0, 1, 2, 3, 8, 10, 11}) == "0-3,8,10-11"


@pytest.fixture
def affinity():
    """The process's affinity, given back to every thread afterwards."""
    saved = os.sched_getaffinity(0)
    yield saved
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), saved)
        except (ProcessLookupError, PermissionError):
            pass


def _card(tmp_path, local, numa="0"):
    dev = tmp_path / BUS
    dev.mkdir()
    if local is not None:
        (dev / "local_cpulist").write_text(local + "\n")
    (dev / "numa_node").write_text(numa + "\n")
    return tmp_path


def test_place_meets_local_and_allowed(tmp_path, affinity):
    allowed = sorted(affinity)
    far = max(allowed) + 100
    want = set(allowed[:2])
    local = ",".join([host.cpulist(want), f"{far}-{far + 1}"])
    rec = host.place(BUS, _card(tmp_path, local, "1"))
    assert rec["placed"] and host.parse_cpulist(rec["cpus"]) == want
    assert rec["numa_node"] == 1 and host.parse_cpulist(rec["local_cpulist"]) == want | {far,
                                                                                         far + 1}
    assert os.sched_getaffinity(0) == want
    for tid in os.listdir("/proc/self/task"):
        assert os.sched_getaffinity(int(tid)) == want


@pytest.mark.parametrize("case", ["file missing", "no CPU in common", "no address"])
def test_place_leaves_placement_when_it_cannot(tmp_path, affinity, case):
    far = max(affinity) + 100
    sysfs = _card(tmp_path, {"file missing": None, "no CPU in common": f"{far}-{far + 3}",
                             "no address": "0"}[case])
    rec = host.place(None if case == "no address" else BUS, sysfs)
    assert not rec["placed"] and "left as it was" in rec["why"]
    assert os.sched_getaffinity(0) == affinity
    assert host.parse_cpulist(rec["cpus"]) == affinity


def test_cpu_reader_reads_an_allowed_cpu():
    assert host.cpu_reader()() in os.sched_getaffinity(0)


def test_chunk_walls_and_runs():
    assert host.chunk_walls([1.5, 1.75, 2.5], 1.0) == [500000, 250000, 750000]
    assert host.chunk_walls([], 1.0) == []
    assert host.runs([3, 3, 5, 3]) == "3x2 5x1 3x1"
    assert host.runs([]) == ""


def test_thread_seconds_reads_this_thread():
    before = host.thread_ticks()
    t = time.process_time()
    while time.process_time() - t < 0.1:
        pass
    used = dict(host.thread_seconds(before, host.thread_ticks()))
    assert any(name.endswith(f"/{threading.get_native_id()}") and s > 0
               for name, s in used.items())


SHAPE = (240, 320)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_whole_run_keeps_its_series_and_its_line(cell, monkeypatch, capsys, affinity):
    """``harness.main`` end to end on the CPU at a small size, its look for
    a card answered yes: the window's chunks are recorded, the host lines
    go to standard error before the checks, and the result line has the
    keys it always had."""
    real_resolve, real_run = harness.resolve, harness.run_cell
    kept = {}

    def small(bench, name, root=ROOT):
        c, config, traffic, e2e, layers = real_resolve(bench, name, root)
        return c, config, dict(traffic, chunk=4, period=8, check_chunks=1,
                               streams=min(traffic["streams"], 2)), e2e, layers

    def on_cpu(*args, **kwargs):
        kept["run"] = real_run(*args, **dict(kwargs, device="cpu", shape=SHAPE))
        return kept["run"]

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(harness, "resolve", small)
    monkeypatch.setattr(harness, "run_cell", on_cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a CPU in a test")
    monkeypatch.setattr(host, "card_bus_id", lambda i=0: None)
    # the test process may hold modules that a run on the card never loads
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    torch.set_num_threads(2)
    assert harness.main(["--workload", cell, "--seed", str(2**32 + 7), "--seconds", "0",
                         "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and "host" not in json.dumps(line)
    run, r = kept["run"], kept["run"].readings
    traffic = small(BENCH, cell)[2]
    chunks = run.frames // (traffic["streams"] * traffic["chunk"])
    assert len(r["chunk_walls"]) == len(r["chunk_cpus"]) == len(r["chunk_calls"]) == chunks > 0
    assert sum(r["chunk_walls"]) <= 1e6 * run.window_s + chunks
    assert [p for p, _ in r["setup_parts"]] == ["python", "torch", "cuda", "inputs", "init",
                                                "capture", "steady"]
    err_lines = err.strip().splitlines()
    for word in ("placement placed=False", "setup_parts_s", "window frames=", "window call_s",
                 "chunk_wall_us", "chunk_call_us", "chunk_cpu", "thread_cpu_s", "cpu_probe_ns"):
        assert any(ln.startswith(f"vobench: host {word}") for ln in err_lines), word
    checks = [ln for ln in err_lines if ln.startswith("check ")]
    assert checks and err_lines[-len(checks):] == checks


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("chunks", [1, 2, 5])
def test_drained_chunks_are_the_concatenation(batched, chunks):
    """The preallocated drain gives what appending a copy of each chunk and
    concatenating along the frame axis gave."""
    from vobench.loops.chunked import Drained

    lead = (3, 4) if batched else (4,)
    gen = torch.Generator().manual_seed(chunks)
    bufs = {"T_world": torch.empty(lead + (4, 4)), "flag": torch.empty(lead, dtype=torch.bool)}
    drained, kept = Drained({k: b.numpy() for k, b in bufs.items()}, block=2), {k: [] for k in bufs}
    for _ in range(chunks):
        bufs["T_world"].copy_(torch.randn(lead + (4, 4), generator=gen))
        bufs["flag"].copy_(torch.rand(lead, generator=gen) > 0.5)
        drained.put({k: b.numpy() for k, b in bufs.items()})
        for k, b in bufs.items():
            kept[k].append(b.numpy().copy())
    got = drained.arrays(batched)
    for k, v in kept.items():
        want = np.concatenate(v, axis=1 if batched else 0)
        assert got[k].shape == want.shape and got[k].dtype == want.dtype
        assert np.array_equal(got[k], want)
