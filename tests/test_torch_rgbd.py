"""The RGB-D slice and the monocular pipeline seeded with measured depth:
the port's ``rgbd_run``/``rgbd_run_raw`` and ``monocular_init_with_depth``
against ``dvo_tpu.models.odometry`` (XLA twins) on the same seeded
sequences, with the initial state carried across by
``rgbd_state_from_reference``.

Tolerances, from the measured port-vs-twin spread on these inputs (3.5e-6
on the 4-level case, 7.6e-7 on the 2-level one): world poses and twists
within 1e-5, per-level GN iteration counts equal (no count flipped at the
1.5e-3 update-norm gate here).  The raw-input path is held bit for bit:
the depth conversion multiplies by the float32-rounded 1/depth_scale as
``dvo_tpu`` does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import DVOConfig, PyramidConfig, TrackerConfig
from dvo_tpu.models import odometry as jodo
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import odometry as todo

from test_odometry import render_sequence
from test_torch_odometry import CFG as MONO_CFG
from test_torch_odometry import TCFG as MONO_TCFG
from test_torch_odometry import _reset_planes

torch.set_num_threads(1)

N = 6
STEP = np.array([0.006, -0.002, 0.004, 0.001, 0.001, -0.0005], np.float32)
CASES = {
    # name: (input H, W, config)
    "levels2": (64, 96, DVOConfig(pyramid=PyramidConfig(levels=2, culls=0))),
    "rgbd": (212, 256, DVOConfig.rgbd()),   # culled to a 106x128 base, 4 levels
}


def _sequence(h, w, seed=0):
    """(grays, masks, depths, sigmas, K): a static scene under constant
    motion; depth of frame k is depth0 - k * tz (tests/test_odometry.py)."""
    frames, depth0, K = render_sequence(np.random.default_rng(seed), N, h, w, STEP)
    grays = np.stack([f[0] for f in frames])
    masks = np.stack([f[1] for f in frames])
    depths = np.stack([depth0 - k * STEP[2] for k in range(N)]).astype(np.float32)
    sigmas = np.full((N, h, w), 0.1, np.float32)
    return grays, masks, depths, sigmas, K


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.fixture(scope="module", params=sorted(CASES))
def rgbd_runs(request):
    h, w, cfg = CASES[request.param]
    grays, masks, depths, sigmas, K = _sequence(h, w)
    st0 = jodo.rgbd_init(*_j(grays[0], masks[0], depths[0], sigmas[0], K), cfg)
    stj, rj = jodo.rgbd_run(st0, *_j(grays[1:], masks[1:], depths[1:], sigmas[1:], K), cfg)
    sp = todo.rgbd_state_from_reference(jax.tree.map(np.asarray, st0), "cpu")
    stp, rp = todo.rgbd_run(sp, *_t(grays[1:], masks[1:], depths[1:], sigmas[1:], K),
                            config_from_reference(cfg))
    return (stj, rj), (stp, rp)


def test_rgbd_run_matches_dvo_tpu(rgbd_runs):
    (stj, rj), (stp, rp) = rgbd_runs
    np.testing.assert_array_equal(rp.tracking.iterations.numpy(),
                                  np.asarray(rj.tracking.iterations))
    np.testing.assert_allclose(rp.T_world.numpy(), np.asarray(rj.T_world), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rp.relative_xi.numpy(), np.asarray(rj.relative_xi),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(stp.vel.numpy(), np.asarray(stj.vel), rtol=0, atol=1e-5)
    assert stp.frame_count == int(stj.frame_count) == N
    assert stp.ref.frame_id == int(stj.ref.frame_id) == N - 1
    assert bool(rp.is_keyframe.all())


@pytest.fixture(scope="module")
def small_sequence():
    return _sequence(64, 96)


@pytest.mark.parametrize("driver", ["two_chunks", "per_frame", "shared_mask"])
def test_chunked_run_equals_per_frame(small_sequence, driver):
    """The warm-start velocity rides in RGBDState, so a run split into
    chunks, or stepped frame by frame, equals one chunk exactly; one (H, W)
    mask for the chunk equals that mask repeated per frame."""
    grays, masks, depths, sigmas, K = small_sequence
    cfg = config_from_reference(
        dataclasses.replace(DVOConfig.rgbd(), pyramid=PyramidConfig(levels=2, culls=0)))
    s0 = todo.rgbd_init(*_t(grays[0], masks[0], depths[0], sigmas[0], K), cfg, device="cpu")
    rest = (grays[1:], masks[1:], depths[1:], sigmas[1:])
    if driver == "shared_mask":
        rest = (grays[1:], np.repeat(masks[:1], N - 1, axis=0), depths[1:], sigmas[1:])
    s_one, r_one = todo.rgbd_run(s0, *_t(*rest, K), cfg)
    if driver == "two_chunks":
        s, ra = todo.rgbd_run(s0, *_t(*(x[:2] for x in rest), K), cfg)
        s, rb = todo.rgbd_run(s, *_t(*(x[2:] for x in rest), K), cfg)
        T = torch.cat([ra.T_world, rb.T_world])
    elif driver == "per_frame":
        s, Ts = s0, []
        for i in range(N - 1):
            s, r = todo.rgbd_step(s, *_t(*(x[i] for x in rest), K), cfg)
            Ts.append(r.T_world)
        T = torch.stack(Ts)
    else:
        s, r = todo.rgbd_run(s0, *_t(grays[1:], masks[0], depths[1:], sigmas[1:], K), cfg)
        T = r.T_world
    torch.testing.assert_close(T, r_one.T_world, rtol=0, atol=0)
    torch.testing.assert_close(s.vel, s_one.vel, rtol=0, atol=0)
    assert (s_one.vel != 0).any()


def _raw(grays, depths):
    u8 = np.clip(np.round(grays * 255), 0, 255).astype(np.uint8)
    counts = np.clip(np.round(depths * 5000), 0, 65535).astype(np.uint16)
    counts[:, ::7, ::5] = 0                       # holes: no measurement
    return u8, counts


@pytest.mark.parametrize("culls", [0, 1])
def test_rgbd_run_raw_equals_host_converted(small_sequence, culls):
    """uint8 gray and uint16 counts converted on the device give the run
    that host-converted floats give, bit for bit."""
    grays, masks, depths, _, K = small_sequence
    u8, counts = _raw(grays, depths)
    cfg = config_from_reference(
        dataclasses.replace(DVOConfig.rgbd(), pyramid=PyramidConfig(levels=2, culls=culls)))
    gray_f = u8.astype(np.float32) * np.float32(1.0 / 255.0)
    depth_f = counts.astype(np.float32) * np.float32(1.0 / 5000.0)
    sigma_f = np.where(depth_f > 1e-6, 0.1, 1.0).astype(np.float32)

    s0 = todo.rgbd_init(*_t(gray_f[0], masks[0], depth_f[0], sigma_f[0], K), cfg,
                        device="cpu")
    s_raw, r_raw = todo.rgbd_run_raw(s0, *_t(u8[1:], masks[1:], counts[1:], K), cfg)
    s_f, r_f = todo.rgbd_run(s0, *_t(gray_f[1:], masks[1:], depth_f[1:], sigma_f[1:], K), cfg)
    torch.testing.assert_close(r_raw.T_world, r_f.T_world, rtol=0, atol=0)
    for a, b in zip(s_raw.ref.scenes, s_f.ref.scenes):
        for name in ("gray", "depth", "sigma"):
            torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=0)
    assert (s_raw.ref.base.sigma == 1.0).any() and (s_raw.ref.base.sigma < 1.0).any()


def test_raw_depth_conversion_matches_dvo_tpu(small_sequence):
    """The converted depth and the synthesised sigma of ``rgbd_run_raw``
    equal ``dvo_tpu``'s bit for bit, over the whole uint16 range and after
    the chunk cull."""
    grays, masks, depths, _, K = small_sequence
    u8, counts = _raw(grays[:3], depths[:3])
    counts[-1, 0, :8] = [1, 2, 3, 4999, 5000, 5001, 65534, 65535]
    cfg = DVOConfig(pyramid=PyramidConfig(levels=2, culls=1),
                    tracker=TrackerConfig(max_iterations=1))
    gray_f = u8[0].astype(np.float32) * np.float32(1.0 / 255.0)
    d0 = depths[0]
    s0 = jodo.rgbd_init(*_j(gray_f, masks[0], d0, np.full_like(d0, 0.1), K), cfg)
    stj, _ = jodo.rgbd_run_raw(s0, *_j(u8[1:], masks[1:3], counts[1:], K), cfg)
    sp = todo.rgbd_state_from_reference(jax.tree.map(np.asarray, s0), "cpu")
    stp, _ = todo.rgbd_run_raw(sp, *_t(u8[1:], masks[1:3], counts[1:], K),
                               config_from_reference(cfg))
    for a, b in zip(stp.ref.scenes, stj.ref.scenes):
        for name in ("depth", "sigma", "gray"):
            np.testing.assert_array_equal(getattr(a, name).numpy(), np.asarray(getattr(b, name)))
    d, s = todo.raw_depth(torch.from_numpy(counts[-1]))
    want = jnp.asarray(counts[-1]).astype(jnp.float32) * jnp.float32(1.0 / 5000.0)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want))
    assert s.dtype == torch.float32


# --------------------------------------------------- mono seeded with depth

@pytest.fixture(scope="module")
def mono_depth_runs():
    h, w = 60, 80
    step = np.array([0.012, 0.003, 0.002, 0.001, -0.002, 0.001], np.float32)
    frames, depth0, K = render_sequence(np.random.default_rng(0), 7, h, w, step)
    grays = np.stack([f[0] for f in frames])
    masks = np.stack([f[1] for f in frames])
    sigma0 = np.full((h, w), 0.05, np.float32)
    st0 = jodo.monocular_init_with_depth(*_j(grays[0], masks[0], depth0, sigma0, K),
                                         jax.random.PRNGKey(4), MONO_CFG)
    stj, rj = jodo.monocular_run(st0, *_j(grays[1:], masks[1:], K), MONO_CFG)
    sp = todo.monocular_init_with_depth(*_t(grays[0], masks[0], depth0, sigma0, K), MONO_TCFG,
                                        device="cpu")
    stp, rp = todo.monocular_run(sp, *_t(grays[1:], masks[1:], K), MONO_TCFG,
                                 reset_depths=torch.from_numpy(_reset_planes(st0.key, 6, MONO_CFG)))
    return (stj, rj), (stp, rp)


def test_monocular_init_with_depth_matches_dvo_tpu(mono_depth_runs):
    (stj, rj), (stp, rp) = mono_depth_runs
    kf = rp.is_keyframe.numpy()
    np.testing.assert_array_equal(kf, np.asarray(rj.is_keyframe))
    assert kf.any() and (~kf).any()
    np.testing.assert_array_equal(rp.tracking.iterations.numpy(),
                                  np.asarray(rj.tracking.iterations))
    np.testing.assert_allclose(rp.T_world.numpy(), np.asarray(rj.T_world), rtol=0, atol=1e-5)
    for stat in ("observed", "accepted", "rejected"):
        t, j = getattr(rp.mapping, stat).numpy(), np.asarray(getattr(rj.mapping, stat))
        assert np.all(np.abs(t - j) <= np.maximum(2, 0.01 * j)), (stat, t, j)
    assert stp.frame_count == int(stj.frame_count)


def _signature(x, path=""):
    """{path: (shape, dtype name)} over a dataclass tree of arrays."""
    if dataclasses.is_dataclass(x):
        out = {}
        for f in dataclasses.fields(x):
            out.update(_signature(getattr(x, f.name), f"{path}.{f.name}"))
        return out
    if isinstance(x, torch.Tensor):
        return {path: (tuple(x.shape), str(torch.empty(0, dtype=x.dtype).numpy().dtype))}
    return {path: (tuple(x.shape), str(np.asarray(x).dtype))}


def test_step_result_fields_match_dvo_tpu(mono_depth_runs, rgbd_runs):
    """A mono and an RGB-D run's stacked StepResult have dvo_tpu's field
    names, shapes and dtypes, BA fields included (ba_cost -1, ba_window_xi
    (N, 0, 6) with BA off)."""
    for (_, rj), (_, rp) in (mono_depth_runs, rgbd_runs):
        assert _signature(rp) == _signature(rj)
        assert ".ba_cost" in _signature(rp) and ".ba_window_xi" in _signature(rp)
        np.testing.assert_array_equal(rp.ba_cost.numpy(), np.asarray(rj.ba_cost))
        assert (rp.ba_cost.numpy() == -1.0).all()
