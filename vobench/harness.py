"""One run of one cell: ``python3 -m vobench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout.

The cell, its configuration, its traffic mix and its metrics are found by
name through ``BENCHMARK.json``: the configuration's file, the mix's data
file ``vobench/traffic/<traffic>.json``, the loop that the mix names
(``vobench/loops/<loop>.py``, which runs the window and judges it), the
judge's limits ``vobench/limits/<cell>.json`` and, for each metric, end to
end or per layer, the reader ``vobench/metrics/<metric>.py``.  Nothing here
names a cell, a loop or a metric.

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced, the
``breakdown``; its last key, ``checks``, holds every number the judge
compared with its limit, which also end standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path.cwd()
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dvo_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def setup_clock():
    """A clock of the seconds since the process started."""
    offset = process_age_s() - time.perf_counter()
    return lambda: time.perf_counter() + offset


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, cell_name: str, root: Path = ROOT):
    """(cell, configuration dict, traffic dict, end-to-end metrics,
    per-layer metrics) of a cell, every file found by its name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)

    def mine(m):
        return cell_name in m.get("workloads", [cell_name])

    return (cell, config, traffic, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def reader(name: str):
    """The metric ``name``'s reader: ``read(ctx) -> float | None`` in
    ``vobench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(run, cuda_devices: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cuda_devices,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        info["busy_s"] = run.trace.union_s()
        info["window_s"] = run.trace.window_s
    return info


def loop(traffic: dict):
    """The mix's loop: the module ``vobench/loops/<loop>.py``."""
    return importlib.import_module(f"vobench.loops.{traffic['loop']}")


def run_cell(cell, config, traffic, seed, seconds, trace, device="cuda", clock=None,
             shape=None):
    """Drive the cell's loop: a ``drivers.Run``."""
    return loop(traffic).run(config, traffic, seed, seconds, trace, device=device,
                             setup_clock=clock, shape=shape)


def limits(cell_name: str) -> dict:
    """The cell's limits: ``vobench/limits/<cell>.json``."""
    with open(HERE / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def judge(cell, config, traffic, run, control: bool = False):
    """(correct, [(name, value, limit)])."""
    from vobench.judge import verdict

    return verdict(limits(cell["name"]), loop(traffic).judge(config, traffic, run, control))


def read_metrics(entries, ctx, required: bool) -> dict:
    """{name: {value, unit}} of the metrics ``entries``, each from its
    reader.  A per-layer reader that finds nothing leaves its metric out;
    an end-to-end one (``required``) may not."""
    out = {}
    for m in entries:
        value = reader(m["name"])(ctx)
        if value is None and required:
            raise RuntimeError(f"the end-to-end metric {m['name']} read nothing")
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    clock = setup_clock()
    ap = argparse.ArgumentParser(prog="python3 -m vobench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_benchmark()
    cell, config, traffic, e2e, layers = resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"vobench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = run_cell(cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                   clock=clock)
    ctx = SimpleNamespace(run=run, config=config, traffic=traffic, cell=cell, trace=run.trace)
    metrics = read_metrics(layers, ctx, False) if args.trace else read_metrics(e2e, ctx, True)
    device = device_info(run, cell["chips"])
    t = time.perf_counter()
    correct, rows = judge(cell, config, traffic, run)
    print(f"vobench: judged in {time.perf_counter() - t:.1f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"vobench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    # every frame of the window gave its pose; whether the poses are right is ``correct``
    line = {"correct": correct, "attempted": run.frames, "failed": 0,
            "metrics": metrics, "device": device}
    if run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.gaps()}
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    print(json.dumps(line), flush=True)
    for name, value, limit in rows:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    return 0
