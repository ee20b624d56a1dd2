"""The measurement path fails without a card and never falls back to the
CPU; without the program beside it the benchmark fails too."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(cwd, cell="mono.offline"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-m", "vobench", "--workload", cell, "--seed",
                           "3000000001", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_no_card_no_result(cell):
    out = _run(ROOT, cell)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_loops_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell, config, traffic, _, _ = harness.resolve(BENCH, "mono.offline", ROOT)
    with pytest.raises((RuntimeError, AssertionError)):
        harness.run_cell(cell, config, traffic, 1, 0.0, False, device="cuda", shape=(48, 64))


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(ROOT / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    config = json.loads((ROOT / "vobench/configs/mono-640x480.json").read_text())
    probe = ("import json, sys\nfrom vobench import program\n"
             "program.dvo_config(json.load(open('vobench/configs/mono-640x480.json')))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode != 0 and "dvo_tpu_torch" in out.stderr
    assert config["name"] == "mono-640x480"
    assert _run(tmp_path).returncode != 0
