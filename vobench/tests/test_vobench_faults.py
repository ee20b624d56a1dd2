"""The judge on whole runs at a small size on the CPU (the program's plain
versions, the harness's look for a card skipped): a sound run is correct,
and a run with the timed path broken underneath is not, for each fault a
cell can have: a step that returns its state unchanged, half of the
streams left out, a pose altered where it is produced."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from vobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SHAPE = (240, 320)


def run_and_judge(cell_name, seed=2**31 + 5):
    cell, config, traffic, _, _ = harness.resolve(BENCH, cell_name, ROOT)
    traffic = dict(traffic, chunk=4, period=8, check_chunks=1,
                   streams=min(traffic["streams"], 2))
    torch.set_num_threads(2)
    run = harness.run_cell(cell, config, traffic, seed, 0.0, False, device="cpu", shape=SHAPE)
    assert run.frames > 0 and run.samples
    return harness.judge(cell, config, traffic, run)


def _patch_step(monkeypatch, cell_name, wrap):
    from dvo_tpu_torch.models import odometry

    if cell_name == "rgbd.offline":
        monkeypatch.setattr(odometry, "rgbd_step", wrap(odometry.rgbd_step))
    else:
        monkeypatch.setattr(odometry, "monocular_step", wrap(odometry.monocular_step))


def unchanged(step):
    def faulty(state, *args, **kwargs):
        _, result = step(state, *args, **kwargs)
        return state, result
    return faulty


def altered(step):
    def faulty(state, *args, **kwargs):
        new, result = step(state, *args, **kwargs)
        return new, dataclasses.replace(result, T_world=result.T_world + 1e-3)
    return faulty


CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    correct, rows = run_and_judge(cell)
    assert correct, rows


@pytest.mark.parametrize("fault", [unchanged, altered], ids=["state unchanged", "pose altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, monkeypatch):
    _patch_step(monkeypatch, cell, fault)
    correct, rows = run_and_judge(cell)
    assert not correct, rows


def test_half_the_streams_left_out(monkeypatch):
    from dvo_tpu_torch.models import graphed

    real = graphed.run

    def half(owner, states, *args, **kwargs):
        out, results, drivers = real(owner, states, *args, **kwargs)
        return [s if b % 2 else o for b, (s, o) in enumerate(zip(states, out))], results, drivers

    monkeypatch.setattr(graphed, "run", half)
    correct, rows = run_and_judge("mono.fleet8")
    assert not correct, rows


def test_rgbd_streams_beyond_one_are_refused():
    """The RGB-D driver has no stream axis: a mix of two RGB-D streams is
    refused by the run and by the judge, never run or judged on one."""
    cell, config, traffic, _, _ = harness.resolve(BENCH, "rgbd.offline", ROOT)
    two = dict(traffic, chunk=4, period=8, check_chunks=1, streams=2)
    with pytest.raises(ValueError, match="one RGB-D stream"):
        harness.run_cell(cell, config, two, 1, 0.0, False, device="cpu", shape=SHAPE)
    with pytest.raises(ValueError, match="one RGB-D stream"):
        harness.judge(cell, config, two, run=None)
