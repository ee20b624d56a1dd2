"""The port's sequence runners (``dvo_tpu_torch.utils.runner``) against
``dvo_tpu.utils.runner`` on the same PNG sequences, decoded by the same
data plane.

The reference is ``dvo_tpu``'s per-frame path (``chunk=0``; its chunked
scan is a slow test).  The port runs per frame and chunked (``chunk=4``:
two chunks and a one-frame tail).  Tolerances, from the twin-vs-twin
spread of the slice tests (~1e-7): world poses within 1e-5, keyframe flags
equal, timestamps equal.  8-bit gray PNGs make the chunked path's rint ->
uint8 quantisation exact, so chunked and per-frame differ only by float
noise (x / 255 on the device against x * (1 / 255) on the host).

Monocular runs draw their bootstrap noise and reset planes from
``jax.random`` in ``dvo_tpu``; the port's runner gets the same planes
through its ``monocular_*`` entry points, patched here (``Planes``).

Kinect: ``dvo_tpu.utils.runner.run_kinect`` compiles its registration
(``map_depth_to_gray``) with ``jax.jit``, and XLA's fused arithmetic rounds
the registered gray differently from the same function run op by op (by
one ulp, 6e-8, on ~1.5% of the pixels; the masks and sigmas are equal).
Tracking on these small synthetic rigs amplifies that to 3e-3 (RGB-D) and
2e-2 (mono) on the poses.  The port registers op by op, bit for bit as
``dvo_tpu``'s function does (test_torch_ops), so the Kinect reference is
``dvo_tpu``'s runner with its registration left uncompiled
(``_uncompiled_registration``); the rest of its pipeline stays compiled.

The Kinect mono rig has its own sequence (``write_kinect`` with seed 3,
the mono step and no depth holes).  On the RGB-D rig, and on most other
seeds, the coarse level's GN runs all 15 iterations without converging
and ``dvo_tpu``'s mono run itself jumps by 1e-2 to 0.8 between two
inputs one float apart; that is no test of the port."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dvo_tpu.config import DVOConfig, MapperConfig, PyramidConfig, TrackerConfig
from dvo_tpu.utils import runner as jrun
from dvo_tpu.utils.datasets import Calibration, InfoSequence, KinectCalibration
from dvo_tpu.utils.metrics import MetricsLogger as JMetrics
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.utils import runner as trun
from dvo_tpu_torch.utils.metrics import MetricsLogger

from test_odometry import render_sequence

torch.set_num_threads(1)

H, W = 120, 160            # written frames; culls=1 -> a 60x80 base
N = 10                     # frames: 9 steps = two 4-chunks + a 1-frame tail
CHUNK = 4
STEP = np.array([0.012, 0.003, 0.002, 0.001, -0.002, 0.001], np.float32)
RGBD_STEP = np.array([0.006, -0.003, 0.004, 0.001, -0.001, 0.0015], np.float32)
DEPTH_SCALE = 5000.0
POSE_TOL = 1e-5
# The slice tests' reduced configuration, culled once from 120x160.
MONO_CFG = DVOConfig(
    pyramid=PyramidConfig(levels=2, culls=1),
    tracker=TrackerConfig(min_residual=0.0),
    mapper=MapperConfig(crop_x=(8, 72), crop_y=(6, 54), max_steps=40, max_forward=4,
                        luminance_sigma=0.25, epipolar_sigma=0.25, accept_sigma=(0.0, 2.0)),
)
RGBD_CFG = DVOConfig(pyramid=PyramidConfig(levels=2, culls=1),
                     tracker=TrackerConfig(min_residual=0.0))
# The port's own classes with the same values.
MONO_TCFG = config_from_reference(MONO_CFG)
RGBD_TCFG = config_from_reference(RGBD_CFG)


def write_png(path, arr):
    Image.fromarray(arr).save(path)


def calibration(K, h=H, w=W):
    """``K`` with a mild radial distortion: the undistortion remap and its
    border mask (constant per rig) are exercised too."""
    return Calibration(K=K.astype(np.float32),
                       distortion=np.array([0.02, 0.0, 0.0, 0.0, 0.0], np.float32),
                       resolution=(w, h))


def to_u8(img):
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def write_mono(root, seed=0, n=N):
    """A monocular info.txt sequence of 8-bit gray PNGs; returns its
    calibration."""
    frames, _, K = render_sequence(np.random.default_rng(seed), n, H, W, STEP)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "info.txt"), "w") as f:
        for i, (img, _) in enumerate(frames):
            write_png(os.path.join(root, f"{i:04d}.png"), to_u8(img))
            f.write(f"{i:04d}.png\n")
    return calibration(K)


def write_rgbd(root, seed=1, n=N):
    """An RGB-D info.txt sequence ("gray depth" pairs): 8-bit gray and
    16-bit depth counts (1/5000 m, 2% holes); returns its calibration."""
    rng = np.random.default_rng(seed)
    frames, depth0, K = render_sequence(rng, n, H, W, RGBD_STEP)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "info.txt"), "w") as f:
        for i, (img, _) in enumerate(frames):
            counts = np.round((depth0 - i * RGBD_STEP[2]) * DEPTH_SCALE).astype(np.uint16)
            counts[rng.random(counts.shape) < 0.02] = 0
            write_png(os.path.join(root, f"g{i:04d}.png"), to_u8(img))
            write_png(os.path.join(root, f"d{i:04d}.png"), counts)
            f.write(f"g{i:04d}.png d{i:04d}.png\n")
    return calibration(K)


def write_kinect(root, seed=2, n=N, holes=0.02, baseline=0.0, step=RGBD_STEP):
    """A Kinect pair sequence: RGB color at twice the depth camera's size
    (R = G = B, so the luma is the gray exactly) and 16-bit depth at
    120x160, both seen from the depth camera's pose (the frames are
    rendered there); returns the dual-camera calibration, whose extrinsic
    ``invT`` moves a point by ``baseline`` along x.  With ``baseline`` 0
    the registration reproduces the rendered gray."""
    rng = np.random.default_rng(seed)
    frames, depth0, K = render_sequence(rng, n, H, W, step)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "info.txt"), "w") as f:
        for i, (img, _) in enumerate(frames):
            color = np.repeat(np.repeat(to_u8(img), 2, axis=0), 2, axis=1)
            counts = np.round((depth0 - i * step[2]) * DEPTH_SCALE).astype(np.uint16)
            counts[rng.random(counts.shape) < holes] = 0
            write_png(os.path.join(root, f"c{i:04d}.png"), np.stack([color] * 3, axis=-1))
            write_png(os.path.join(root, f"d{i:04d}.png"), counts)
            f.write(f"c{i:04d}.png d{i:04d}.png\n")
    K_rgb = K.copy()
    K_rgb[:2] *= 2.0
    invT = np.eye(4, dtype=np.float32)
    invT[0, 3] = baseline
    return KinectCalibration(
        rgb=Calibration(K=K_rgb.astype(np.float32), resolution=(2 * W, 2 * H)),
        depth=calibration(K), invT=invT)


def jax_planes(key, n, h, w, cfg, split_init):
    """The bootstrap noise and per-step reset planes ``dvo_tpu`` draws from
    ``key``: ``monocular_init`` splits off the noise key (``split_init``),
    every step splits (key, k_frame, k_reset)."""
    noise = None
    if split_init:
        key, sub = jax.random.split(key)
        noise = np.asarray(jax.random.normal(sub, (h, w)))
    lo, hi = cfg.mapper.depth_filter.reset_depth_range
    planes = []
    for _ in range(n):
        key, _, k_reset = jax.random.split(key, 3)
        u = jax.random.uniform(k_reset, (h, w), minval=lo, maxval=hi)
        planes.append(np.asarray(jnp.minimum(u, cfg.mapper.depth_filter.reset_depth_cap)))
    return noise, np.stack(planes)


class Planes:
    """Feeds ``dvo_tpu``'s planes, in step order, to the port runner's
    ``monocular_init`` / ``monocular_step`` / ``monocular_run``."""

    def __init__(self, monkeypatch, noise, resets):
        self.noise, self.resets, self.used = noise, resets, 0
        init, step, run = trun.monocular_init, trun.monocular_step, trun.monocular_run
        monkeypatch.setattr(trun, "monocular_init",
                            lambda *a, **k: init(*a, noise=torch.tensor(self.noise), **k))
        monkeypatch.setattr(trun, "monocular_step",
                            lambda *a, **k: step(*a, reset_depth=self.take(1)[0], **k))
        monkeypatch.setattr(trun, "monocular_run",
                            lambda s, g, *a, **k: run(s, g, *a, reset_depths=self.take(len(g)),
                                                      **k))

    def take(self, n):
        out = torch.tensor(self.resets[self.used:self.used + n])
        self.used += n
        return out


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    root = tmp_path_factory.mktemp("seqs")
    return dict(
        mono=(str(root / "mono"), write_mono(str(root / "mono"))),
        rgbd=(str(root / "rgbd"), write_rgbd(str(root / "rgbd"))),
        kinect_rgbd=(str(root / "kinect"), write_kinect(str(root / "kinect"))),
        kinect_mono=(str(root / "kinect_mono"),
                     write_kinect(str(root / "kinect_mono"), seed=3, holes=0.0, step=STEP)))


def _seq(path):
    return InfoSequence(os.path.join(path, "info.txt"))


def _uncompiled_registration(mp):
    """``run_kinect`` builds its registration with ``jax.jit`` at call time;
    leave it uncompiled (see the module docstring)."""
    mp.setattr(jax, "jit", lambda fn, **kw: fn)


@pytest.fixture(scope="module")
def reference(sequences):
    """``dvo_tpu``'s per-frame runs, each with its metrics records."""
    out = {}
    for name, run in [
        ("mono", lambda p, c, m: jrun.run_monocular(_seq(p), c, MONO_CFG, seed=3, metrics=m)),
        ("rgbd", lambda p, c, m: jrun.run_rgbd(_seq(p), c, RGBD_CFG, metrics=m)),
        ("kinect_rgbd", lambda p, c, m: jrun.run_kinect(_seq(p), c, RGBD_CFG, "rgbd",
                                                        metrics=m)),
        ("kinect_mono", lambda p, c, m: jrun.run_kinect(_seq(p), c, MONO_CFG, "mono",
                                                        metrics=m)),
    ]:
        path, calib = sequences[name]
        log = os.path.join(os.path.dirname(path), f"jax_{name}.jsonl")
        metrics = JMetrics(log)
        with pytest.MonkeyPatch.context() as mp:
            if name.startswith("kinect"):
                _uncompiled_registration(mp)
            ts, poses, _ = run(path, calib, metrics)
        metrics.close()
        with open(log) as f:
            out[name] = (ts, poses, [json.loads(line) for line in f])
    return out


def _port_run(name, sequences, chunk, monkeypatch, metrics=None):
    path, calib = sequences[name]
    if name == "mono":
        h, w = H >> 1, W >> 1
        Planes(monkeypatch, *jax_planes(jax.random.PRNGKey(3), N - 1, h, w, MONO_CFG, True))
        return trun.run_monocular(_seq(path), calib, MONO_TCFG, seed=3, chunk=chunk,
                                  metrics=metrics, device="cpu")
    if name == "rgbd":
        return trun.run_rgbd(_seq(path), calib, RGBD_TCFG, chunk=chunk, metrics=metrics,
                             device="cpu")
    mode = name.split("_")[1]
    if mode == "mono":
        _, resets = jax_planes(jax.random.PRNGKey(0), N - 1, H >> 1, W >> 1, MONO_CFG, False)
        Planes(monkeypatch, None, resets)
    return trun.run_kinect(_seq(path), calib, MONO_TCFG if mode == "mono" else RGBD_TCFG, mode,
                           chunk=chunk, metrics=metrics, device="cpu")


def _matches_reference(name, chunk, sequences, reference, monkeypatch, tmp_path):
    ts_j, poses_j, records_j = reference[name]
    log = str(tmp_path / "port.jsonl")
    metrics = MetricsLogger(log)
    ts, poses, secs = _port_run(name, sequences, chunk, monkeypatch, metrics)
    metrics.close()
    with open(log) as f:
        records = [json.loads(line) for line in f]
    np.testing.assert_array_equal(ts, ts_j)
    assert poses.shape == poses_j.shape == (N, 4, 4) and secs.shape == (N - 1,)
    np.testing.assert_allclose(poses, poses_j, rtol=0, atol=POSE_TOL)
    assert [r["keyframe"] for r in records] == [r["keyframe"] for r in records_j]
    if name.endswith("mono"):   # the mapper ran on both branches
        assert any(r["keyframe"] for r in records) and not all(r["keyframe"] for r in records)
        assert any(r["map_accepted"] > 0 for r in records)
    for r, rj in zip(records, records_j):
        assert r.keys() == rj.keys()
        assert r["t"] == rj["t"] and r["gn_iters"] == rj["gn_iters"]
        assert r["ba_cost"] is None and rj["ba_cost"] is None
        for key in ("valid_pixels", "map_observed", "map_accepted", "map_rejected"):
            assert np.all(np.abs(np.asarray(r[key]) - np.asarray(rj[key]))
                          <= np.maximum(2, 0.01 * np.asarray(rj[key]))), key


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["per_frame", "chunked"])
@pytest.mark.parametrize("name", ["rgbd", "mono", "kinect_rgbd", "kinect_mono"])
def test_runner_matches_dvo_tpu(name, chunk, sequences, reference, monkeypatch, tmp_path):
    _matches_reference(name, chunk, sequences, reference, monkeypatch, tmp_path)


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["per_frame", "chunked"])
@pytest.mark.parametrize("name", ["rgbd", "mono", "kinect_rgbd", "kinect_mono"])
def test_runner_pil_route_matches_dvo_tpu(name, chunk, sequences, reference, monkeypatch,
                                          tmp_path):
    """The PIL decode route, which a machine without libpng takes, against
    the same reference (decoded natively): these sequences hold 8-bit gray,
    16-bit depth and R = G = B color PNGs, which both routes decode alike,
    so the tolerances are the same."""
    from dvo_tpu_torch import native

    def no_native(*a, **k):
        raise AssertionError("the native loader ran on the PIL route")

    monkeypatch.setattr(trun, "decode_route", lambda: "pil")
    monkeypatch.setattr(native, "PrefetchLoader", no_native)
    _matches_reference(name, chunk, sequences, reference, monkeypatch, tmp_path)


def test_decode_routes_agree_on_gray_and_bound_color_luma(tmp_path):
    """What the two decode routes give for one PNG: 8-bit gray and 16-bit
    depth equal; color within half a level, as the runner's docstring
    states (PIL rounds the luma, native keeps its fraction), and equal
    after rounding on all but the near-ties."""
    from dvo_tpu_torch import native
    from dvo_tpu_torch.utils.datasets import decode_gray

    rng = np.random.default_rng(0)
    images = dict(gray=rng.integers(0, 256, (48, 64), dtype=np.uint8),
                  depth=rng.integers(0, 65536, (48, 64), dtype=np.uint16),
                  color=rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    got = {}
    for kind, img in images.items():
        path = str(tmp_path / f"{kind}.png")
        write_png(path, img)
        got[kind] = native.decode_png_f32(path, 1.0), decode_gray(path)
    for kind in ("gray", "depth"):
        np.testing.assert_array_equal(*got[kind])
        np.testing.assert_array_equal(got[kind][1], images[kind])
    nat, pil = got["color"]
    assert np.abs(nat - pil).max() <= 0.5
    assert (np.rint(nat) != pil).mean() <= 1e-3


def test_metrics_records_match_dvo_tpu_logger(tmp_path):
    """The port's logger writes ``dvo_tpu``'s record for the same result,
    whether the row holds tensors or numpy arrays."""
    from dvo_tpu.models.mapper import DepthUpdateStats as JStats
    from dvo_tpu.models.odometry import StepResult as JResult
    from dvo_tpu.models.tracker import TrackResult as JTrack
    from dvo_tpu_torch.models.mapper import DepthUpdateStats
    from dvo_tpu_torch.models.odometry import StepResult
    from dvo_tpu_torch.models.tracker import TrackResult

    rng = np.random.default_rng(0)
    leaves = dict(
        T_world=rng.random((4, 4), np.float32), relative_xi=rng.random(6, np.float32),
        is_keyframe=np.bool_(True), ba_cost=np.float32(-1.0),
        ba_window_xi=np.zeros((0, 6), np.float32))
    track = dict(xi=rng.random(6, np.float32), residuals=rng.random((2, 5), np.float32),
                 update_norms=rng.random((2, 5), np.float32),
                 valid_counts=rng.integers(0, 99, (2, 5)).astype(np.int32),
                 iterations=np.array([3, 5], np.int32))
    track["residuals"][0, 3:] = 0.0
    stats = dict(observed=np.int32(7), accepted=np.int32(5), rejected=np.int32(2),
                 aged_out=np.int32(1))
    want = JResult(**leaves, tracking=JTrack(**track), mapping=JStats(**stats))
    t = lambda d: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    for row in (StepResult(**t(leaves), tracking=TrackResult(**t(track)),
                           mapping=DepthUpdateStats(**t(stats))),
                StepResult(**leaves, tracking=TrackResult(**track),
                           mapping=DepthUpdateStats(**stats))):
        logs = []
        for logger_cls in (MetricsLogger, JMetrics):
            path = str(tmp_path / f"{logger_cls.__module__}.jsonl")
            logger = logger_cls(path)
            logger.log_frame(row if logger_cls is MetricsLogger else want, 0.0123, 4.0)
            logger.close()
            with open(path) as f:
                logs.append(f.read())
        assert logs[0] == logs[1]


def test_disabled_metrics_logger_copies_nothing():
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError("the disabled logger read the result")

    logger = MetricsLogger(None)
    logger.log_frame(Untouchable(), 0.1)
    assert not logger.enabled


@pytest.mark.parametrize("runner", ["rgbd", "mono"])
def test_chunked_path_requires_a_constant_mask(runner, sequences, monkeypatch):
    """The mask is staged once, so a frame-varying one must raise rather
    than be replaced silently."""
    stream = trun._image_stream

    def varying(*a, **k):
        for i, (img, valid) in enumerate(stream(*a, **k)):
            if i == 3:
                valid = valid.copy()
                valid[0, 0] = not valid[0, 0]
            yield img, valid

    monkeypatch.setattr(trun, "_image_stream", varying)
    path, calib = sequences[runner]
    run = trun.run_rgbd if runner == "rgbd" else trun.run_monocular
    cfg = RGBD_TCFG if runner == "rgbd" else MONO_TCFG
    with pytest.raises(ValueError, match="constant validity mask"):
        run(_seq(path), calib, cfg, chunk=CHUNK, device="cpu")


def test_result_packing_round_trips_exactly():
    """One (N, D) float32 pack of every leaf and back: values and dtypes
    equal, the empty BA window included."""
    from dvo_tpu_torch.models.mapper import DepthUpdateStats
    from dvo_tpu_torch.models.odometry import StepResult
    from dvo_tpu_torch.models.tracker import TrackResult

    g = torch.Generator().manual_seed(0)
    n = 3
    res = StepResult(
        T_world=torch.rand((n, 4, 4), generator=g), relative_xi=torch.rand((n, 6), generator=g),
        is_keyframe=torch.tensor([True, False, True]),
        tracking=TrackResult(torch.rand((n, 6), generator=g), torch.rand((n, 2, 4), generator=g),
                             torch.rand((n, 2, 4), generator=g),
                             torch.randint(0, 1 << 20, (n, 2, 4), generator=g, dtype=torch.int32),
                             torch.randint(0, 15, (n, 2), generator=g, dtype=torch.int32)),
        mapping=DepthUpdateStats(*(torch.randint(0, 9999, (n,), generator=g,
                                                 dtype=torch.int32) for _ in range(4))),
        ba_cost=torch.full((n,), -1.0), ba_window_xi=torch.zeros((n, 0, 6)))
    flat = trun._flatten_results(res)
    assert flat.shape == (n, 16 + 6 + 1 + 6 + 8 * 3 + 2 + 4 + 1) and flat.dtype == torch.float32
    back = trun._unflatten_results(res, flat.numpy())
    for a, b in zip(trun._leaves(back), trun._leaves(res)):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    rows = []
    drain = trun._ChunkDrain(lambda i, row: rows.append((i, row)))
    drain.push(res, 5, n)
    assert rows == []               # consumed one chunk behind
    drain.finish()
    assert [i for i, _ in rows] == [5, 6, 7]
    np.testing.assert_array_equal(rows[1][1].T_world, res.T_world[1].numpy())
    assert rows[1][1].is_keyframe == np.bool_(False)


def test_staging_alternates_two_sets_and_copies():
    staging = trun._Staging([((2, 3), torch.uint8), ((2, 3), torch.uint16)], "cpu")
    a = staging.acquire()
    a[0][:] = 7
    a[1][:] = 60000
    dev_a = staging.upload()
    b = staging.acquire()
    assert b[0].ctypes.data != a[0].ctypes.data
    b[0][:] = 1
    staging.upload()
    assert staging.acquire()[0].ctypes.data == a[0].ctypes.data
    a[0][:] = 9                     # refilling the set does not change what was shipped
    assert dev_a[0].dtype == torch.uint8 and dev_a[1].dtype == torch.uint16
    assert int(dev_a[0].max()) == 7 and int(dev_a[1].to(torch.int32).min()) == 60000


def test_timer_and_device_sync_on_cpu():
    """``device_sync`` has nothing to wait for on the CPU; ``Timer`` still
    measures the block."""
    from dvo_tpu_torch.utils.metrics import Timer, device_sync

    x = torch.ones(3)
    device_sync(x)
    device_sync(np.ones(3))
    with Timer(sync=x) as t:
        time.sleep(0.01)
    assert t.ms >= 10.0
