"""``dvo_tpu_torch.utils.checkpoint`` (with ``dvo_tpu``'s key layout),
``utils.viz.keyframe_gallery`` and ``utils.stream.run_stream``.

Tolerances: a checkpoint that ``dvo_tpu`` wrote loads into the same
numbers as ``state_from_reference`` of the live state, and both continue
bit for bit; against ``dvo_tpu``'s own next steps, poses within 1e-5 (the
slice tolerance, test_torch_odometry).  A port checkpoint resumes bit for
bit on the CPU, its generator included.  ``run_stream`` against
``run_monocular`` per frame: poses within 1e-5 (the stream decodes each
file by itself, the runner through a prefetching stream, so the gray
values may round differently by one float)."""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.models import odometry as jodo
from dvo_tpu.utils import checkpoint as jckpt
from dvo_tpu.utils.datasets import InfoSequence
from dvo_tpu.utils.viz import keyframe_gallery as jgallery
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.utils import checkpoint as tckpt
from dvo_tpu_torch.utils import runner as trun
from dvo_tpu_torch.utils.stream import run_stream, watch_directory
from dvo_tpu_torch.utils.viz import keyframe_gallery

from test_odometry import render_sequence
from test_torch_odometry import CFG, TCFG, H, STEP, W, _reset_planes
from test_torch_runner import MONO_TCFG, write_mono

torch.set_num_threads(1)

N_SAVED = 5          # frames the saved state has seen (frame 4 is promoted)
N_NEXT = 2           # frames run after the save
POSE_TOL = 1e-5


@pytest.fixture(scope="module")
def frames():
    frames, depth0, K = render_sequence(np.random.default_rng(0), N_SAVED + N_NEXT, H, W, STEP)
    grays = np.stack([f[0] for f in frames])
    masks = np.stack([f[1] for f in frames])
    depths = np.stack([depth0 - k * STEP[2] for k in range(len(frames))]).astype(np.float32)
    return grays, masks, depths, np.full_like(depths, 0.1), K


def _jax_run(kind, frames):
    """``dvo_tpu``'s state after N_SAVED frames, and its next N_NEXT world
    poses."""
    grays, masks, depths, sigmas, K = (jnp.asarray(a) for a in frames)
    if kind == "mono":
        st = jodo.monocular_init(grays[0], masks[0], K, jax.random.PRNGKey(3), CFG)
        step = lambda s, i: jodo.monocular_step(s, grays[i], masks[i], K, CFG)
    else:
        st = jodo.rgbd_init(grays[0], masks[0], depths[0], sigmas[0], K, CFG)
        step = lambda s, i: jodo.rgbd_step(s, grays[i], masks[i], depths[i], sigmas[i], K,
                                           CFG)
    for i in range(1, N_SAVED):
        st, _ = step(st, i)
    saved, poses = st, []
    for i in range(N_SAVED, N_SAVED + N_NEXT):
        st, res = step(st, i)
        poses.append(np.asarray(res.T_world))
    return saved, np.stack(poses)


@pytest.fixture(scope="module")
def jax_runs(frames):
    return {kind: _jax_run(kind, frames) for kind in ("mono", "rgbd")}


def _port_steps(kind, state, frames, resets=None):
    """The port's next N_NEXT steps from ``state``: (state, poses)."""
    grays, masks, depths, sigmas, K = (torch.tensor(a) for a in frames)
    poses = []
    for k, i in enumerate(range(N_SAVED, N_SAVED + N_NEXT)):
        if kind == "mono":
            reset = None if resets is None else torch.tensor(resets[k])
            state, res = todo.monocular_step(state, grays[i], masks[i], K, TCFG, reset)
        else:
            state, res = todo.rgbd_step(state, grays[i], masks[i], depths[i], sigmas[i], K,
                                        TCFG)
        poses.append(res.T_world)
    return state, torch.stack(poses)


def _assert_same_state(a, b):
    la, lb = dict(tckpt._leaves(a)), dict(tckpt._leaves(b))
    assert la.keys() == lb.keys()
    for key in la:
        x, y = la[key], lb[key]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), key
        else:
            assert x == y, key


@pytest.mark.parametrize("kind", ["mono", "rgbd"])
def test_dvo_tpu_checkpoint_loads_and_continues(kind, frames, jax_runs, tmp_path):
    saved, want = jax_runs[kind]
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, saved)
    with np.load(path) as data:
        assert ("history/depth" in data.files) == (kind == "mono")
        assert "ref/scenes/0/gray" in data.files and ("key" in data.files) == (kind == "mono")
    loaded = tckpt.load_state(path, "cpu")
    host = jax.tree.map(np.asarray, saved)
    if kind == "mono":
        assert isinstance(loaded, todo.VOState)
        direct = todo.state_from_reference(host, "cpu")
        resets = _reset_planes(saved.key, N_NEXT, CFG)
    else:
        assert isinstance(loaded, todo.RGBDState)
        direct = todo.rgbd_state_from_reference(host, "cpu")
        resets = None
    _assert_same_state(loaded, direct)
    end_a, got = _port_steps(kind, loaded, frames, resets)
    end_b, ref = _port_steps(kind, direct, frames, resets)
    assert torch.equal(got, ref)
    _assert_same_state(end_a, end_b)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POSE_TOL)


@pytest.mark.parametrize("kind", ["mono", "rgbd"])
def test_port_checkpoint_round_trip_resumes_bit_identically(kind, frames, tmp_path):
    grays, masks, depths, sigmas, K = (torch.tensor(a) for a in frames)
    if kind == "mono":
        state = todo.monocular_init(grays[0], masks[0], K, TCFG, device="cpu",
                                    generator=torch.Generator().manual_seed(11))
        state, _ = todo.monocular_run(state, grays[1:N_SAVED], masks[1:N_SAVED], K, TCFG)
    else:
        state = todo.rgbd_init(grays[0], masks[0], depths[0], sigmas[0], K, TCFG, device="cpu")
        state, _ = todo.rgbd_run(state, grays[1:N_SAVED], masks[1:N_SAVED],
                                 depths[1:N_SAVED], sigmas[1:N_SAVED], K, TCFG)
    path = str(tmp_path / "port.npz")
    tckpt.save_state(path, state)
    loaded = tckpt.load_state(path, "cpu")
    _assert_same_state(loaded, state)
    # The reset planes come from each state's generator: the restored one
    # must draw what the live one draws.
    end_live, live = _port_steps(kind, state, frames)
    end_loaded, resumed = _port_steps(kind, loaded, frames)
    assert torch.equal(live, resumed)
    _assert_same_state(end_loaded, end_live)
    if kind == "mono":
        assert torch.equal(end_live.generator.get_state(), end_loaded.generator.get_state())


@pytest.mark.parametrize("drop,expect", [("history/kf_id", "warns"),
                                         ("history/depth", "raises"),
                                         ("ref/scenes/1/gx", "raises")])
def test_missing_leaves_follow_the_allowlist(drop, expect, frames, tmp_path):
    grays, masks, _, _, K = (torch.tensor(a) for a in frames)
    state = todo.monocular_init(grays[0], masks[0], K, TCFG, device="cpu")
    full = str(tmp_path / "full.npz")
    tckpt.save_state(full, state)
    with np.load(full) as data:
        kept = {k: data[k] for k in data.files if k != drop}
    path = str(tmp_path / "cut.npz")
    np.savez(path, **kept)
    if expect == "raises":
        with pytest.raises(KeyError, match=drop):
            tckpt.load_state(path, "cpu")
        return
    with pytest.warns(UserWarning, match="kf_id"):
        loaded = tckpt.load_state(path, "cpu")
    assert torch.equal(loaded.history.kf_id,
                       torch.full((CFG.mapper.history_capacity,), -1, dtype=torch.int32))
    assert torch.equal(loaded.history.depth, state.history.depth)


def test_keyframe_gallery_matches_dvo_tpu(jax_runs):
    saved, _ = jax_runs["mono"]
    port = todo.state_from_reference(jax.tree.map(np.asarray, saved), "cpu")
    assert port.history.count >= 2
    np.testing.assert_array_equal(keyframe_gallery(port.history), jgallery(saved.history))


def test_run_stream_matches_the_runner(tmp_path):
    """Frames a producer thread drops into a directory, odometrised as they
    appear, give ``run_monocular``'s per-frame poses."""
    seq = str(tmp_path / "seq")
    calib = write_mono(seq, n=6)
    live = tmp_path / "live"
    live.mkdir()
    names = [it.gray_path for it in InfoSequence(os.path.join(seq, "info.txt"))]

    def produce():
        for p in names:
            with open(p, "rb") as f:
                blob = f.read()
            tmp = live / (os.path.basename(p) + ".part")
            tmp.write_bytes(blob)
            os.replace(tmp, live / os.path.basename(p))
            time.sleep(0.05)

    producer = threading.Thread(target=produce)
    producer.start()
    seen = []
    traj = str(tmp_path / "live.txt")
    _, poses, secs = run_stream(watch_directory(str(live), poll_s=0.01, idle_timeout_s=1.0),
                                calib, MONO_TCFG, seed=4, trajectory_out=traj,
                                on_pose=lambda i, T: seen.append(i), device="cpu")
    producer.join(timeout=30)
    assert not producer.is_alive()
    _, want, _ = trun.run_monocular(InfoSequence(os.path.join(seq, "info.txt")), calib,
                                    MONO_TCFG, seed=4, device="cpu")
    assert poses.shape == want.shape == (6, 4, 4) and seen == list(range(6))
    np.testing.assert_allclose(poses, want, rtol=0, atol=POSE_TOL)
    assert len(secs) == 6 and np.loadtxt(traj).shape == (6, 8)
