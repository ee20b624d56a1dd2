"""Every entry of BENCHMARK.json resolves to its files by name, and a new
configuration, traffic mix, loop, end-to-end and per-layer metric and cell
load as new files and entries, with no edit to a file that is there."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from vobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_resolves(cell):
    c, config, traffic, e2e, layers = harness.resolve(BENCH, cell, ROOT)
    assert config["name"] == c["config"]
    loop = harness.loop(traffic)
    assert callable(loop.run) and callable(loop.judge)
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
    assert layers
    for m in e2e + layers:
        assert callable(harness.reader(m["name"]))
    assert harness.limits(cell)


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)


def test_every_file_is_named():
    files = {c["file"] for c in BENCH["configs"]}
    assert len(files) == len(BENCH["configs"])
    for f in files:
        assert (ROOT / f).is_file() and f.startswith(tuple(p + "/" for p in BENCH["paths"]))
    for c in BENCH["workloads"]:
        assert (ROOT / "vobench" / "traffic" / f"{c['traffic']}.json").is_file()
        assert (ROOT / "vobench" / "limits" / f"{c['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "vobench" / "metrics" / f"{m['name']}.py").is_file()


def test_config_matches_the_program_preset():
    from vobench import program

    for entry in BENCH["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        assert config["reduced"] == entry["reduced"] == []
        program.dvo_config(config)


def test_added_files_load_without_edits(tmp_path):
    shutil.copytree(ROOT / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((ROOT / "vobench/configs/mono-640x480.json").read_text())
    config["name"] = "mono-752x480"
    config["input"].update(height=480, width=752)
    (tmp_path / "vobench/configs/mono-752x480.json").write_text(json.dumps(config))
    (tmp_path / "vobench/traffic/offline48.json").write_text(json.dumps(
        {"loop": "paced", "streams": 1, "chunk": 48, "period": 96, "check_chunks": 1,
         "trace_chunks": 2}))
    (tmp_path / "vobench/loops/paced.py").write_text(
        "import types\n"
        "def run(config, traffic, seed, seconds, trace, device='cuda', setup_clock=None,\n"
        "        shape=None):\n"
        "    return types.SimpleNamespace(frames=traffic['chunk'], window_s=2.0, setup_s=3.0,\n"
        "                                 latency_s=0.25)\n"
        "def judge(config, traffic, run, control=False):\n"
        "    return types.SimpleNamespace(values={'pose_gap': 0.5})\n")
    (tmp_path / "vobench/metrics/frames_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.frames)\n")
    (tmp_path / "vobench/metrics/latency_ms.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx.run.latency_s\n")
    (tmp_path / "vobench/limits/mono752.offline48.json").write_text(json.dumps({"pose_gap": 1}))
    bench["configs"].append({"name": "mono-752x480", "source": "a test",
                             "file": "vobench/configs/mono-752x480.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "mono752.offline48", "config": "mono-752x480",
                               "traffic": "offline48", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "frames_per_s", "workloads": ["mono752.offline48"]})
    bench["end_to_end"][0]["workloads"].append("mono752.offline48")
    bench["end_to_end"].append({"name": "latency_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["mono752.offline48"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json, types\n"
        "from vobench import harness\n"
        "b = harness.load_benchmark()\n"
        "cell, config, traffic, e2e, layers = harness.resolve(b, 'mono752.offline48')\n"
        "run = harness.run_cell(cell, config, traffic, 1, 2.0, False)\n"
        "ctx = types.SimpleNamespace(run=run, trace=types.SimpleNamespace(frames=7))\n"
        "print(json.dumps([config['input']['width'], traffic['chunk'],\n"
        "                  harness.read_metrics(e2e, ctx, True), [m['name'] for m in layers],\n"
        "                  harness.reader('frames_traced')(ctx), harness.limits(cell['name']),\n"
        "                  harness.judge(cell, config, traffic, run)]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(tmp_path),
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    width, chunk, e2e, layers, traced, limits, verdict = json.loads(out.stdout.splitlines()[-1])
    assert (width, chunk, traced, limits) == (752, 48, 7.0, {"pose_gap": 1})
    assert e2e == {"frames_per_s": {"value": 24.0, "unit": "frames/s"},
                   "setup_s": {"value": 3.0, "unit": "s"},
                   "latency_ms": {"value": 250.0, "unit": "ms"}}
    assert layers == ["frames_traced"] and verdict == [True, [["pose_gap", 0.5, 1]]]
