"""The ``mono.ba`` cell's judge (``loops/chunked_ba.py``) on whole runs at a
small size on the CPU (the program's plain versions): a sound run is
correct and holds at least one full-window solve, and a run with BA broken
underneath the timed path is not, by one of BA's own numbers: BA skipped,
four iterations where five are due, the write-back into the ring dropped,
BA's products rounded to TF32 (the control's precision, which the CPU
does not have, emulated on the operands of its contractions).

On the card (``card``): the cell's window issues no op of BA's on the
host: per frame the input copy, one graph launch and the result put, and
no read back to the host."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from vobench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SHAPE = (240, 320)
# chunks of 16 over a 64-frame path: the third chunk, the judged one, holds
# full-window solves (the 7-keyframe ring fills by frame 33), enough of them
# that BA's products in TF32 show (chunks of 8 hold one or two, on which
# they part from float32 by no more than the noise does)
SMALL = dict(chunk=16, period=64, check_chunks=1)


def run_and_judge(seed=2**31 + 5, shape=SHAPE):
    cell, config, traffic, _, _ = harness.resolve(BENCH, "mono.ba", ROOT)
    traffic = dict(traffic, **SMALL)
    torch.set_num_threads(2)
    run = harness.run_cell(cell, config, traffic, seed, 0.0, False, device="cpu", shape=shape)
    assert run.frames > 0 and run.samples
    return harness.judge(cell, config, traffic, run)


def ba_over_limit(rows) -> list:
    return [name for name, value, limit in rows
            if name.startswith("ba_") and not (value is not None and value <= limit)]


def test_sound_run_holds_solves():
    correct, rows = run_and_judge()
    values = {name: value for name, value, _ in rows}
    assert correct and values["ba_unchecked"] == 0.0, rows


def skipped(monkeypatch):
    from dvo_tpu_torch.models import odometry

    monkeypatch.setattr(odometry, "_windowed_ba", lambda *args: None)


def four_iterations(monkeypatch):
    from dvo_tpu_torch.models import odometry

    real = odometry.bundle_adjust
    monkeypatch.setattr(odometry, "bundle_adjust",
                        lambda window, cfg: real(window, dataclasses.replace(cfg, iterations=4)))


def write_back_dropped(monkeypatch):
    """The region's writes into the ring's rows (its indexed puts) dropped."""
    from dvo_tpu_torch.ops.cuda import _build

    real = _build.when

    def when(pred, body, counter):
        real(pred, lambda put: body(lambda dst, value, index=None:
                                    None if index is not None else put(dst, value)), counter)

    monkeypatch.setattr(_build, "when", when)


def _tf32(t):
    """``t`` (float32) with its mantissa rounded to TF32's 10 bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Torch:
    """``torch`` with ``einsum``'s operands rounded to TF32, as a TF32
    product rounds them."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(equation, *operands):
        return torch.einsum(equation, *(_tf32(x) if x.dtype == torch.float32 else x
                                        for x in operands))


def tf32_products(monkeypatch):
    from dvo_tpu_torch.models import ba

    monkeypatch.setattr(ba, "torch", _TF32Torch())


@pytest.mark.parametrize("fault", [skipped, four_iterations, write_back_dropped, tf32_products],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    correct, rows = run_and_judge()
    assert not correct and ba_over_limit(rows), rows


def test_tf32_emulation_rounds():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9, 3.0])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9, 3.0]


def _issued(config_name, card, seed=2**31 + 9):
    """A chunk of a configuration's program after set-up, under the
    profiler: (the host events inside its ``dvo.issue`` span, its results,
    every event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vobench import program
    from vobench.drivers import make_inputs

    entry = {c["name"]: c for c in BENCH["configs"]}[config_name]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = {"streams": 1, "period": 120}
    cfg = program.dvo_config(config)
    inp = make_inputs(config, traffic, seed, card)
    n = 24
    state = program.mono_init(inp.gray[:, 0].to(card), inp.mask, inp.K, cfg, inp.noise, card)

    def chunk(state, k):
        return program.mono_chunk(state, inp.gray[:, k * n:(k + 1) * n].to(card), inp.mask,
                                  inp.K, cfg, inp.resets[:, k * n:(k + 1) * n])

    for k in range(3):
        state, res = chunk(state, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, res = chunk(state, 3)
        torch.cuda.synchronize()
    events = prof.events()
    (issue,) = [e for e in events if e.name == "dvo.issue"]
    start, end = issue.time_range.start, issue.time_range.end
    inside = [e for e in events if e.device_type == DeviceType.CPU
              and start < e.time_range.start and e.time_range.end <= end]
    return inside, res, events


@pytest.mark.card
def test_window_issues_no_op_of_ba(card):
    """On the host, a chunk with BA issues what one without BA issues: per
    frame one graph launch and the driver's copies, no read back to the
    host; BA's solves run on the card, inside the graph's IF nodes."""
    from torch.autograd import DeviceType

    with_ba, res, events = _issued("mono-640x480-ba7", card)
    without, _, _ = _issued("mono-640x480", card)
    assert int((res.ba_cost >= 0).sum()) > 0
    for inside in (with_ba, without):
        names = {e.name for e in inside}
        assert sum(e.name == "cudaGraphLaunch" for e in inside) == 24
        assert not names & {"aten::_local_scalar_dense", "aten::item", "cudaStreamSynchronize",
                            "cudaDeviceSynchronize", "cudaMemcpy"}, names
    ops = lambda inside: {e.name for e in inside if e.name.startswith("aten::")}
    assert ops(with_ba) == ops(without), (ops(with_ba), ops(without))
    assert sum(e.name == "dvo_stage_ba" for e in events
               if e.device_type == DeviceType.CUDA) == int((res.ba_cost >= 0).sum())
