"""On the card (skipped here): each cell's control, the reference in TF32 in
the program's place, fails the judge on three seeds, and the program passes
on the same runs.  ``python -m pytest vobench/tests -k card`` on the card;
the readings that the limits were set from come from ``python3 -m
vobench.control`` at the cells' own load (PERF.md)."""

import json
from pathlib import Path

import pytest

from vobench import harness, judge

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell_name", [c["name"] for c in BENCH["workloads"]])
def test_control_fails_and_program_passes(cell_name, card):
    cell, config, traffic, _, _ = harness.resolve(BENCH, cell_name, ROOT)
    traffic = dict(traffic, check_chunks=1)
    judged = harness.loop(traffic).judge
    limits = harness.limits(cell_name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        run = harness.run_cell(cell, config, traffic, seed, 1.0, False, device=card)
        ok, rows = judge.verdict(limits, judged(config, traffic, run, False))
        assert ok, rows
        bad, rows = judge.verdict(limits, judged(config, traffic, run, True))
        assert not bad, rows
