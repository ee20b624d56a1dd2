"""``python -m dvo_tpu_torch.run --ba --trace`` on the card: a step with
windowed BA is captured with a CUDA graph IF node, which must not happen
while a profiler records, so the CLI starts its profiler after the first
chunk.  Marked ``card``; skips without one.  Run it on the card with

    python -m pytest --noconftest -o addopts= -m card tests/test_torch_cli_card.py

(``--noconftest``: ``tests/conftest.py`` configures JAX, which that machine
does not have; nothing here imports it).  The sequence is
``chip_smoke.py``'s rendered rig (640x480, constant small motion), written
as PNGs by its zlib writer."""

import contextlib
import io
import json
import os

import pytest
import torch

pytestmark = pytest.mark.card

FRAMES = 33        # the first frame and four chunks of 8
CHUNK = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: python -m pytest --noconftest -o addopts= -m card "
                    "tests/test_torch_cli_card.py")
    return torch.device("cuda", 0)


def test_trace_with_ba(cuda, tmp_path):
    """Every frame odometrised, and the trace holds the chunks after the
    first, BA's solves among them: the ``ba`` stage's marker on the card and
    the IF node's condition kernel once a frame."""
    import chip_smoke
    from dvo_tpu_torch import run

    grays, _, K, _ = chip_smoke.render_sequence(cuda)
    seq = chip_smoke.write_sequence(str(tmp_path / "seq"), grays[:FRAMES].cpu().numpy())
    yaml = chip_smoke.write_calib(str(tmp_path / "mono.yaml"),
                                  {"monocular": (K.cpu().numpy(), chip_smoke.W, chip_smoke.H)})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run.main(["--data", seq, "--calib", yaml, "--mode", "mono", "--ba", "--chunk", str(CHUNK),
                  "--trace", str(tmp_path / "trace"), "--out", str(tmp_path / "t.txt")])
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    assert report["frames"] == FRAMES
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        names = [ev.get("name", "") for ev in json.load(f)["traceEvents"]]
    traced_frames = FRAMES - 1 - CHUNK
    assert names.count("dvo.chunk") == traced_frames // CHUNK
    # the profiler may lose a window's first device event
    assert traced_frames - 1 <= sum("set_condition" in name for name in names) <= traced_frames
    assert names.count("dvo_stage_ba") > 0
