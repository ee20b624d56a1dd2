"""The runner's PIL route decodes on a bounded thread pool
(``utils/runner._pooled``): frames come out in order, no more than
``ahead`` are in flight, a decode error reaches the caller at its frame, and
the pooled stream yields exactly what decoding on the calling thread
(``PIL_THREADS = 1``) yields."""

import threading
import time

import numpy as np
import pytest
from PIL import Image

from dvo_tpu_torch.utils import runner as trun


def test_pooled_keeps_order_and_bounds_the_frames_in_flight():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.004, 40)
    lock, state = threading.Lock(), {"now": 0, "most": 0}

    def work(i):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        time.sleep(delays[i])
        with lock:
            state["now"] -= 1
        return i * i

    got = []
    for out in trun._pooled(work, range(40), threads=4, ahead=6):
        got.append(out)
        time.sleep(0.001)
    assert got == [i * i for i in range(40)]
    assert state["most"] <= 4


def test_pooled_submits_at_most_ahead_items():
    submitted = []

    def items():
        for i in range(20):
            submitted.append(i)
            yield i

    stream = trun._pooled(lambda i: i, items(), threads=2, ahead=3)
    assert next(stream) == 0
    assert len(submitted) <= 4       # three ahead, one more after the first yield
    assert list(stream) == list(range(1, 20))


def test_pooled_raises_at_the_failing_item():
    def work(i):
        if i == 5:
            raise ValueError("frame 5 is corrupt")
        return i

    got = []
    with pytest.raises(ValueError, match="frame 5"):
        for out in trun._pooled(work, range(12), threads=3, ahead=4):
            got.append(out)
    assert got == [0, 1, 2, 3, 4]


def _write(root, n, rng, dtype, shape):
    paths = []
    for i in range(n):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
        path = str(root / f"{i:03d}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("kind", ["gray", "depth", "color_remap"])
def test_pooled_stream_equals_serial(kind, tmp_path, monkeypatch):
    """Values, masks and their order: the pooled PIL route against the
    calling thread, for 8-bit gray, 16-bit depth and color frames through an
    undistortion-style remap."""
    rng = np.random.default_rng(1)
    h, w = 24, 32
    if kind == "depth":
        paths = _write(tmp_path, 9, rng, np.uint16, (h, w))
    elif kind == "gray":
        paths = _write(tmp_path, 9, rng, np.uint8, (h, w))
    else:
        paths = _write(tmp_path, 9, rng, np.uint8, (h, w, 3))
    srcmap = None
    if kind == "color_remap":
        ys, xs = np.mgrid[0:h:2, 0:w:2].astype(np.float32)
        srcmap = np.ascontiguousarray(np.stack([xs + 0.3, ys - 0.6], axis=-1))
    monkeypatch.setattr(trun, "decode_route", lambda: "pil")
    runs = {}
    for threads in (1, 4):
        monkeypatch.setattr(trun, "PIL_THREADS", threads)
        runs[threads] = list(trun._image_stream(paths, 1 / 255.0, srcmap, []))
    assert len(runs[1]) == len(runs[4]) == len(paths)
    for (a, am), (b, bm) in zip(runs[1], runs[4]):
        assert a.dtype == b.dtype == np.float32 and am.dtype == bm.dtype == bool
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(am, bm)
    # ... in the order of the paths, and frames differ from one another
    for path, (img, valid) in zip(paths, runs[4]):
        want, want_valid = trun._decode_pil(path, 1 / 255.0, srcmap)
        np.testing.assert_array_equal(img, want)
        np.testing.assert_array_equal(valid, want_valid)
    assert not np.array_equal(runs[4][0][0], runs[4][1][0])


def test_pooled_stream_passes_a_decode_error_through(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    paths = _write(tmp_path, 6, rng, np.uint8, (8, 8))
    with open(paths[3], "wb") as f:
        f.write(b"not a png")
    monkeypatch.setattr(trun, "decode_route", lambda: "pil")
    monkeypatch.setattr(trun, "PIL_THREADS", 3)
    got = []
    with pytest.raises(Exception, match="(?i)identify|cannot|png"):
        for frame in trun._image_stream(paths, 1.0, None, []):
            got.append(frame)
    assert len(got) == 3
