"""``python -m dvo_tpu_torch.run`` (``dvo_tpu_torch.run.main``) with
``--device cpu`` against ``python -m dvo_tpu.run`` on the same PNG
sequences.

The RGB-D sequence is rendered at 240x320 from a smooth texture (sums of
low-frequency sines) so that ``DVOConfig.rgbd()``'s four levels, culled
down to 15x20, track it: the sharp texture of ``tests/test_odometry.py``
aliases at that depth and the trajectory runs away in both packages, and
at 120x160 the 8x10 top level amplifies float noise past 1e-5 by the
ninth frame (5.8e-5 measured).  ``dvo_tpu``'s CLI runs per frame (``--chunk 0``:
its chunked scan is a slow compile); the port's runs per frame and chunked.
Tolerance: the TUM trajectory within 1e-5, the runners' tolerance
(test_torch_runner), ATE within its 1e-4 rounding."""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dvo_tpu import lie
from dvo_tpu import run as jcli
from dvo_tpu.ops.warp import warp_image
from dvo_tpu.utils.datasets import Calibration, InfoSequence
from dvo_tpu.utils.trajectory import write_tum
from dvo_tpu_torch import run as tcli
from dvo_tpu_torch.utils import runner as trun
from dvo_tpu_torch.utils.checkpoint import load_state

from test_torch_runner import DEPTH_SCALE, RGBD_STEP, to_u8, write_kinect, write_png

torch.set_num_threads(1)

H, W, N, CHUNK = 240, 320, 10, 4
POSE_TOL = 1e-5


def texture(rng, h, w, lo=0.02, hi=0.1, terms=8):
    """A sum of random low-frequency sines, normalised to [0, 1]."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(terms):
        fx, fy = rng.uniform(lo, hi, 2)
        ph = rng.uniform(0, 6.28, 2)
        img += rng.uniform(0.5, 1.0) * np.sin(fx * xs + ph[0]) * np.sin(fy * ys + ph[1])
    return (img - img.min()) / (img.max() - img.min())


def write_sequence(root, seed=1):
    """An info.txt sequence of "gray depth" pairs (8-bit gray, 16-bit
    counts with 2% holes) under constant motion RGBD_STEP; returns its
    calibration (with a mild radial distortion) and the true world poses."""
    rng = np.random.default_rng(seed)
    base = texture(rng, H, W)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    depth0 = (1.5 + 0.2 * np.sin(0.02 * xs) * np.sin(0.03 * ys)).astype(np.float32)
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]], np.float32)
    os.makedirs(root, exist_ok=True)
    xi = jnp.zeros(6, jnp.float32)
    poses = []
    with open(os.path.join(root, "info.txt"), "w") as f:
        for i in range(N):
            if i:
                xi = lie.compose(xi, jnp.asarray(RGBD_STEP))
            img, _ = warp_image(xi, jnp.asarray(base), jnp.ones((H, W), bool),
                                jnp.asarray(depth0), jnp.asarray(K))
            poses.append(np.asarray(lie.se3_exp(xi)))
            counts = np.round((depth0 - i * RGBD_STEP[2]) * DEPTH_SCALE).astype(np.uint16)
            counts[rng.random(counts.shape) < 0.02] = 0
            write_png(os.path.join(root, f"g{i:04d}.png"), to_u8(np.asarray(img)))
            write_png(os.path.join(root, f"d{i:04d}.png"), counts)
            f.write(f"g{i:04d}.png d{i:04d}.png\n")
    calib = Calibration(K=K, distortion=np.array([0.02, 0, 0, 0, 0], np.float32),
                        resolution=(W, H))
    return calib, np.stack(poses)


def write_yaml(path, sections, invT=None):
    """A calibration YAML as ``Calibration.from_yaml`` and
    ``KinectCalibration.from_yaml`` read it."""
    fmt = lambda a: ", ".join(repr(float(v)) for v in np.asarray(a).ravel())
    with open(path, "w") as f:
        for name, calib in sections.items():
            f.write(f"{name}:\n  K: [{fmt(calib.K)}]\n")
            if calib.distortion is not None:
                f.write(f"  D: [{fmt(calib.distortion)}]\n")
            f.write(f"  resolution: [{calib.resolution[0]}, {calib.resolution[1]}]\n")
        if invT is not None:
            f.write(f"extrinsic:\n  invT: [{fmt(invT)}]\n")


def cli(module, argv):
    """Run ``module.main(argv)``; returns its JSON report."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    seq = str(root / "seq")
    calib, truth = write_sequence(seq)
    write_yaml(str(root / "calib.yaml"), {"monocular": calib})
    write_tum(str(root / "gt.txt"), np.arange(N, dtype=np.float64), truth)
    kin = str(root / "kinect")
    kcal = write_kinect(kin)
    write_yaml(str(root / "kinect.yaml"), {"rgb": kcal.rgb, "depth": kcal.depth}, kcal.invT)
    d = dict(root=root, seq=seq, calib=str(root / "calib.yaml"), gt=str(root / "gt.txt"),
             kinect=kin, kinect_calib=str(root / "kinect.yaml"))
    d["jax_out"] = str(root / "jax.txt")
    d["jax_report"] = cli(jcli, ["--data", seq, "--mode", "rgbd", "--calib", d["calib"],
                                 "--chunk", "0", "--gt", d["gt"], "--out", d["jax_out"]])
    return d


def _tum(path):
    return np.loadtxt(path, ndmin=2)


def _rgbd_cli_matches(chunk, data, tmp_path):
    out = str(tmp_path / "port.txt")
    report = cli(tcli, ["--data", data["seq"], "--mode", "rgbd", "--calib", data["calib"],
                        "--chunk", str(chunk), "--gt", data["gt"], "--out", out,
                        "--device", "cpu"])
    want = data["jax_report"]
    # dvo_tpu adds the short-run note under the same rule (chunk and < 5 chunks).
    assert set(report) - {"note"} == set(want) == {"frames", "fps", "trajectory", "ate_rmse_m"}
    assert ("note" in report) == bool(chunk)
    assert report["frames"] == want["frames"] == N and report["trajectory"] == out
    assert abs(report["ate_rmse_m"] - want["ate_rmse_m"]) <= 1e-4
    assert report["ate_rmse_m"] < 0.02          # it tracked the rendered motion
    got, ref = _tum(out), _tum(data["jax_out"])
    assert got.shape == ref.shape == (N, 8)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=0, atol=POSE_TOL)


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["per_frame", "chunked"])
def test_rgbd_cli_matches_dvo_tpu_run(chunk, data, tmp_path):
    _rgbd_cli_matches(chunk, data, tmp_path)


def test_rgbd_cli_on_the_pil_route_matches_dvo_tpu_run(data, tmp_path, monkeypatch):
    """The CLI when ``dvo_tpu_torch.native`` cannot load (no libpng): PIL
    decodes the same 8-bit gray and 16-bit depth values, so the same
    tolerance."""
    from dvo_tpu_torch import native

    def unavailable():
        raise native.NativeUnavailable("no libpng")

    monkeypatch.setattr(native, "load_library", unavailable)
    trun.decode_route.cache_clear()
    try:
        assert trun.decode_route() == "pil"
        _rgbd_cli_matches(CHUNK, data, tmp_path)
    finally:
        trun.decode_route.cache_clear()


def test_mono_cli_writes_checkpoint_gallery_and_metrics(data, tmp_path):
    out, ckpt, gallery, metrics = (str(tmp_path / n) for n in
                                   ("t.txt", "state.npz", "gallery.png", "m.jsonl"))
    report = cli(tcli, ["--data", data["seq"], "--mode", "mono", "--calib", data["calib"],
                        "--chunk", str(CHUNK), "--seed", "5", "--out", out, "--checkpoint",
                        ckpt, "--gallery", gallery, "--metrics", metrics, "--device", "cpu"])
    assert report["frames"] == N and "note" in report and "ate_rmse_m" not in report
    traj = _tum(out)
    assert traj.shape == (N, 8) and np.isfinite(traj).all()
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    assert len(records) == N - 1 and any(r["keyframe"] for r in records)
    state = load_state(ckpt, "cpu")
    assert state.frame_count == N and state.history.count >= 2
    img = np.asarray(Image.open(gallery))
    assert img.ndim == 3 and img.shape[2] == 3 and img.shape[0] > state.history.count


@pytest.mark.parametrize("mode", ["rgbd", "mono"])
def test_kinect_cli_runs_the_runner(mode, data, tmp_path):
    """``--format kinect`` reads the dual-camera YAML and runs
    ``run_kinect`` (held against ``dvo_tpu`` in test_torch_runner) with the
    CLI's configuration and pre-cull stride: the same trajectory."""
    from dvo_tpu_torch.config import DVOConfig
    from dvo_tpu_torch.utils.datasets import KinectCalibration

    out = str(tmp_path / "t.txt")
    report = cli(tcli, ["--data", data["kinect"], "--format", "kinect", "--mode", mode,
                        "--calib", data["kinect_calib"], "--chunk", str(CHUNK),
                        "--kinect-gray-cull", "2", "--out", out, "--device", "cpu"])
    assert report["frames"] == N
    cfg = DVOConfig.monocular() if mode == "mono" else None
    ts, poses, _ = trun.run_kinect(
        InfoSequence(os.path.join(data["kinect"], "info.txt")),
        KinectCalibration.from_yaml(data["kinect_calib"]), cfg, mode, chunk=CHUNK,
        gray_cull=2, device="cpu")
    ref = out + ".api"
    write_tum(ref, ts, poses)
    np.testing.assert_array_equal(_tum(out), _tum(ref))
    assert np.isfinite(poses).all()


def test_cuda_device_without_a_card_fails(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "t.txt"
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["--data", data["seq"], "--mode", "rgbd", "--calib", data["calib"],
                   "--out", str(out), "--device", "cuda"])
    assert not out.exists()


@pytest.mark.parametrize("flags,ba,pg,every", [
    (["--ba", "--ba-window", "2", "--ba-iters", "2"], (True, 2, 2), False, 0),
    (["--pose-graph"], (False, 7, 5), True, 0),
    (["--ba", "--pose-graph", "--pose-graph-every", "2"], (True, 4, 5), True, 2),
], ids=["ba", "pose_graph", "ba_pose_graph_every"])
def test_back_end_flags_reach_the_runner(flags, ba, pg, every, data, tmp_path, monkeypatch):
    """``--ba [--ba-window M] [--ba-iters N]`` builds the config as
    ``dvo_tpu.run`` does, ``--pose-graph`` and ``--pose-graph-every`` pass
    through, and the run writes the trajectory that ``run_monocular`` gives
    for the same arguments."""
    from dvo_tpu_torch.config import DVOConfig

    seen = {}
    run_monocular = trun.run_monocular

    def spy(seq, calib, cfg, **kw):
        seen.update(cfg=cfg, kw=kw, calib=calib)
        seen["out"] = run_monocular(seq, calib, cfg, **kw)
        return seen["out"]

    monkeypatch.setattr(trun, "run_monocular", spy)
    out, metrics = str(tmp_path / "t.txt"), str(tmp_path / "m.jsonl")
    report = cli(tcli, ["--data", data["seq"], "--mode", "mono", "--calib", data["calib"],
                        "--chunk", str(CHUNK), "--seed", "5", "--out", out, "--metrics", metrics,
                        "--device", "cpu"] + flags)
    cfg = seen["cfg"]
    assert (cfg.ba.enabled, cfg.ba.window, cfg.ba.iterations) == ba
    assert dataclasses.replace(cfg, ba=DVOConfig.monocular().ba) == DVOConfig.monocular()
    assert (seen["kw"]["pose_graph"], seen["kw"]["pose_graph_every"]) == (pg, every)
    assert report["frames"] == N
    traj = _tum(out)
    assert traj.shape == (N, 8) and np.isfinite(traj).all()
    ref = out + ".api"
    write_tum(ref, seen["out"][0], seen["out"][1])
    np.testing.assert_array_equal(traj, _tum(ref))
    with open(metrics) as f:
        costs = [json.loads(line)["ba_cost"] for line in f]
    assert any(c is not None for c in costs) == (flags[1:2] == ["--ba-window"])


def test_back_end_flags_match_dvo_tpu_run_defaults():
    """The same defaults as ``dvo_tpu.run``: window 4, 5 iterations, no
    refinement during the run; the help no longer calls them unported."""
    args = tcli._parser().parse_args(["--data", "x"])
    assert (args.ba, args.ba_window, args.ba_iters) == (False, 4, 5)
    assert (args.pose_graph, args.pose_graph_every) == (False, 0)
    assert "not ported" not in tcli._parser().format_help()
    assert "not ported" not in tcli.__doc__


def _flags(help_text):
    return set(re.findall(r"(--[a-z][a-z-]+)", help_text))


def test_flags_are_dvo_tpu_run_flags_with_device():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        jcli.main(["--help"])
    port_help = tcli._parser().format_help()
    assert _flags(port_help) == _flags(out.getvalue()) - {"--platform"} | {"--device"}
    assert "jax.random" in port_help        # --seed says the mono trajectory differs


def test_stream_cli_follows_a_directory(data, tmp_path):
    """``--stream``: frames that a producer drops into the directory while
    the run goes are odometrised and the TUM file is written live."""
    live = tmp_path / "live"
    live.mkdir()
    frames = sorted(p for p in os.listdir(data["seq"]) if p.startswith("g"))[:5]

    def produce():
        for name in frames:
            tmp = live / (name + ".part")
            shutil.copy(os.path.join(data["seq"], name), tmp)
            os.replace(tmp, live / name)
            time.sleep(0.05)

    producer = threading.Thread(target=produce)
    producer.start()
    out = str(tmp_path / "t.txt")
    report = cli(tcli, ["--data", str(live), "--stream", "--stream-idle", "1.0", "--calib",
                        data["calib"], "--out", out, "--device", "cpu"])
    producer.join(timeout=30)
    assert not producer.is_alive()
    assert report["streamed"] is True and report["frames"] == len(frames)
    assert _tum(out).shape == (len(frames), 8)


def test_trace_writes_a_chrome_trace(data, tmp_path):
    trace = tmp_path / "trace"
    cli(tcli, ["--data", data["seq"], "--mode", "rgbd", "--calib", data["calib"],
               "--max-frames", "3", "--chunk", "0", "--trace", str(trace),
               "--out", str(tmp_path / "t.txt"), "--device", "cpu"])
    with open(trace / "trace.json") as f:
        assert json.load(f)["traceEvents"]
