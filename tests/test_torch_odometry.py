"""The slice end to end: the port's ``monocular_init`` state (carried over
from ``dvo_tpu`` by ``state_from_reference``) and ``monocular_run`` against
``dvo_tpu.models.odometry.monocular_run`` (XLA twins) on the same frames
and the same depth-filter reset planes.

Tolerances, from the measured twin-vs-twin spread (1e-7 here): world poses
within 1e-5, keyframe flags and per-level GN iteration counts equal, the
mapping counts within 1% (or 2 pixels), and the reference depth map within
1e-5 on at least 99.5% of pixels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import DVOConfig, MapperConfig, PyramidConfig, TrackerConfig
from dvo_tpu.models import odometry as jodo
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import odometry as todo

from test_odometry import render_sequence

torch.set_num_threads(1)

H, W, N = 60, 80, 7
STEP = np.array([0.012, 0.003, 0.002, 0.001, -0.002, 0.001], np.float32)
# Reduced-size slice: 2 levels, 60x80, the mapper crop set to the image, a
# 40-step march; a looser sigma model and acceptance band so that the depth
# updates after the first promotion observe a few dozen pixels.
CFG = DVOConfig(
    pyramid=PyramidConfig(levels=2, culls=0),
    tracker=TrackerConfig(min_residual=0.0),
    mapper=MapperConfig(crop_x=(8, 72), crop_y=(6, 54), max_steps=40, max_forward=4,
                        luminance_sigma=0.25, epipolar_sigma=0.25, accept_sigma=(0.0, 2.0)),
)
TCFG = config_from_reference(CFG)   # the port's own classes, same values


@pytest.fixture(scope="module")
def sequence():
    frames, _, K = render_sequence(np.random.default_rng(0), N, H, W, STEP)
    grays = np.stack([f[0] for f in frames])
    masks = np.stack([f[1] for f in frames])
    return grays, masks, K


def _reset_planes(key, n, cfg):
    """The planes dvo_tpu's monocular_step draws: key -> (key, k_frame,
    k_reset) per frame, min(U(k_reset; 0.5, 2), 4) at the base level."""
    lo, hi = cfg.mapper.depth_filter.reset_depth_range
    planes = []
    for _ in range(n):
        key, _, k_reset = jax.random.split(key, 3)
        u = jax.random.uniform(k_reset, (H, W), minval=lo, maxval=hi)
        planes.append(np.asarray(jnp.minimum(u, cfg.mapper.depth_filter.reset_depth_cap)))
    return np.stack(planes)


@pytest.fixture(scope="module")
def runs(sequence):
    grays, masks, K = sequence
    st0 = jodo.monocular_init(jnp.asarray(grays[0]), jnp.asarray(masks[0]), jnp.asarray(K),
                              jax.random.PRNGKey(3), CFG)
    stj, rj = jodo.monocular_run(st0, jnp.asarray(grays[1:]), jnp.asarray(masks[1:]),
                                 jnp.asarray(K), CFG)
    sp = todo.state_from_reference(jax.tree.map(np.asarray, st0), "cpu")
    stp, rp = todo.monocular_run(sp, torch.tensor(grays[1:]), torch.tensor(masks[1:]),
                                 torch.tensor(K), TCFG,
                                 reset_depths=torch.tensor(_reset_planes(st0.key, N - 1, CFG)))
    return (stj, rj), (stp, rp)


def test_slice_exercises_both_mapping_branches(runs):
    (_, rj), (_, rp) = runs
    kf = rp.is_keyframe.numpy()
    assert kf.any() and (~kf).any()
    assert (rp.mapping.accepted.numpy()[~kf] > 0).any()
    assert (rp.mapping.rejected.numpy()[~kf] > 0).any()   # the reset plane is used


def test_slice_poses_and_keyframes_match(runs):
    (_, rj), (_, rp) = runs
    np.testing.assert_array_equal(rp.is_keyframe.numpy(), np.asarray(rj.is_keyframe))
    np.testing.assert_array_equal(rp.tracking.iterations.numpy(), np.asarray(rj.tracking.iterations))
    np.testing.assert_allclose(rp.T_world.numpy(), np.asarray(rj.T_world), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rp.relative_xi.numpy(), np.asarray(rj.relative_xi), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stat", ["observed", "accepted", "rejected", "aged_out"])
def test_slice_mapping_stats_match(runs, stat):
    (_, rj), (_, rp) = runs
    t = getattr(rp.mapping, stat).numpy()
    j = np.asarray(getattr(rj.mapping, stat))
    assert np.all(np.abs(t - j) <= np.maximum(2, 0.01 * j)), (t, j)


def test_slice_reference_keyframe_matches(runs):
    (stj, _), (stp, _) = runs
    want = stj.ref.scenes[-1]
    got = stp.ref.base
    for name in ("depth", "sigma"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        ok = np.abs(g - w) <= 1e-5 * (1.0 + np.abs(w))
        assert ok.mean() >= 0.995, (name, ok.mean())
    assert np.mean(stp.ref.age.numpy() == np.asarray(stj.ref.age)) >= 0.995
    assert stp.ref.frame_id == int(stj.ref.frame_id)
    assert (stp.history.head, stp.history.count) == (int(stj.history.head), int(stj.history.count))
    assert stp.frame_count == int(stj.frame_count) == N


def test_state_round_trip(runs):
    """state_to_numpy -> state_from_reference gives the same state back."""
    (_, _), (stp, _) = runs
    back = todo.state_from_reference(todo.state_to_numpy(stp), "cpu")
    for name in ("gray", "mask", "gx", "gy", "gmask", "depth", "sigma", "xi", "kf_id"):
        torch.testing.assert_close(getattr(back.history, name), getattr(stp.history, name))
    for a, b in zip(back.ref.scenes, stp.ref.scenes):
        for f in dataclasses.fields(a):
            torch.testing.assert_close(getattr(a, f.name), getattr(b, f.name))
    assert (back.history.head, back.history.count, back.frame_count) == (
        stp.history.head, stp.history.count, stp.frame_count)


def test_uint8_input_and_generator_draws(sequence):
    """uint8 frames normalise on the device exactly like host-normalised
    floats; without reset planes the run draws them from the state's
    generator, and the same seed repeats the run exactly."""
    grays, masks, K = sequence
    u8 = np.clip(np.round(grays[:4] * 255), 0, 255).astype(np.uint8)
    noise = torch.randn((H, W), generator=torch.Generator().manual_seed(1))

    def run(frames):
        st = todo.monocular_init(torch.tensor(frames[0]), torch.tensor(masks[0]),
                                 torch.tensor(K), TCFG, noise=noise,
                                 generator=torch.Generator().manual_seed(5))
        return todo.monocular_run(st, torch.tensor(frames[1:]), torch.tensor(masks[0]),
                                  torch.tensor(K), TCFG)[1]

    a, b = run(u8), run(u8)
    c = run(u8.astype(np.float32) / np.float32(255.0))
    torch.testing.assert_close(a.T_world, b.T_world, rtol=0, atol=0)
    torch.testing.assert_close(a.T_world, c.T_world, rtol=1e-6, atol=1e-7)
    assert torch.isfinite(a.T_world).all()


def test_culled_input_matches_pre_culled(sequence):
    """``culls`` decimates the chunk up front: feeding 2x frames with
    culls=1 equals feeding the decimated frames with culls=0."""
    grays, masks, K = sequence
    big = np.repeat(np.repeat(grays[:3], 2, axis=1), 2, axis=2)
    bigm = np.repeat(np.repeat(masks[:3], 2, axis=1), 2, axis=2)
    K2 = K.copy()
    K2[:2] *= 2.0
    K2[2, 2] = 1.0
    cfg1 = config_from_reference(
        dataclasses.replace(CFG, pyramid=PyramidConfig(levels=2, culls=1)))
    noise = torch.zeros((H, W))
    st = todo.monocular_init(torch.tensor(big[0]), torch.tensor(bigm[0]), torch.tensor(K2),
                             cfg1, noise=noise)
    r1 = todo.monocular_run(st, torch.tensor(big[1:]), torch.tensor(bigm[1:]),
                            torch.tensor(K2), cfg1, reset_depths=torch.ones((2, H, W)))[1]
    st = todo.monocular_init(torch.tensor(grays[0]), torch.tensor(masks[0]), torch.tensor(K),
                             TCFG, noise=noise)
    r0 = todo.monocular_run(st, torch.tensor(grays[1:3]), torch.tensor(masks[1:3]),
                            torch.tensor(K), TCFG, reset_depths=torch.ones((2, H, W)))[1]
    torch.testing.assert_close(r1.T_world, r0.T_world, rtol=0, atol=1e-6)


def test_bundle_adjustment_is_refused(sequence):
    grays, masks, K = sequence
    cfg = dataclasses.replace(TCFG, ba=dataclasses.replace(TCFG.ba, enabled=True))
    with pytest.raises(NotImplementedError):
        todo.monocular_init(torch.tensor(grays[0]), torch.tensor(masks[0]), torch.tensor(K), cfg)
