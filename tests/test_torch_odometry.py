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
                                 torch.tensor(K), TCFG, device="cpu", noise=noise,
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
                             cfg1, device="cpu", noise=noise)
    r1 = todo.monocular_run(st, torch.tensor(big[1:]), torch.tensor(bigm[1:]),
                            torch.tensor(K2), cfg1, reset_depths=torch.ones((2, H, W)))[1]
    st = todo.monocular_init(torch.tensor(grays[0]), torch.tensor(masks[0]), torch.tensor(K),
                             TCFG, device="cpu", noise=noise)
    r0 = todo.monocular_run(st, torch.tensor(grays[1:3]), torch.tensor(masks[1:3]),
                            torch.tensor(K), TCFG, reset_depths=torch.ones((2, H, W)))[1]
    torch.testing.assert_close(r1.T_world, r0.T_world, rtol=0, atol=1e-6)


@pytest.mark.parametrize("entry", ["monocular_init", "monocular_init_with_depth", "rgbd_init"])
def test_entry_points_ask_for_the_card_by_default(entry, sequence):
    """Without ``device=`` an entry point runs on the card; where there is
    none it raises and says so — it never runs on the CPU unasked, whatever
    device its inputs lie on.  ``device="cpu"`` is the way to ask."""
    grays, masks, K = sequence
    g, m, k = torch.tensor(grays[0]), torch.tensor(masks[0]), torch.tensor(K)
    d, s = torch.full((H, W), 1.5), torch.full((H, W), 0.1)
    args = (g, m, k) if entry == "monocular_init" else (g, m, d, s, k)
    fn = getattr(todo, entry)
    assert fn.__kwdefaults__["device"] == "cuda"
    if torch.cuda.is_available():
        state = fn(*args, TCFG)
    else:
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
            fn(*args, TCFG)
        state = fn(*args, TCFG, device="cpu")
        assert state.ref.xi.device.type == "cpu"
    assert state.ref.base.gray.device == state.ref.xi.device


def test_load_state_asks_for_the_card_by_default():
    import inspect

    from dvo_tpu_torch.utils import checkpoint, runner, stream
    assert inspect.signature(checkpoint.load_state).parameters["device"].default == "cuda"
    for fn in (runner.run_monocular, runner.run_rgbd, runner.run_kinect, stream.run_stream):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


@pytest.mark.parametrize("branch", ["promotion", "depth_update"])
def test_step_builds_the_reference_in_one_call(branch, sequence, monkeypatch):
    """Per ``monocular_step``: one pyramid build (the tracking frame) and one
    regularize-and-cull, in either mapping branch — no pair or one-plane cull
    and no separate regulariser call.  Both branches are enqueued on every
    frame (the decision is selected on the device), so ``propagate`` runs
    once either way; a promotion pushes the propagated, un-regularised base
    into the ring."""
    from dvo_tpu_torch.models import frame as tframe
    from dvo_tpu_torch.models import mapper as tmapper

    grays, masks, K = sequence
    cfg = dataclasses.replace(TCFG, mapper=dataclasses.replace(
        TCFG.mapper, max_forward=1 if branch == "promotion" else 50, min_movement=1e9))
    state = todo.monocular_init(torch.tensor(grays[0]), torch.tensor(masks[0]),
                                torch.tensor(K), cfg, device="cpu", noise=torch.zeros((H, W)))
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            calls.setdefault(name + "_out", []).append(out := fn(*a, **k))
            return out
        monkeypatch.setattr(module, name, wrapper)

    for name in ("build_pyramid_planes", "cull_pyramid_pair", "cull_pyramid_one",
                 "regularize_cull_pyramid", "regularize"):
        counted(tframe, name)
    counted(todo, "propagate")
    # frame.py on its launch route (the wrappers it calls stay on their plain one)
    monkeypatch.setattr(tframe, "resolve_device", lambda _: "cuda")
    new, res = todo.monocular_step(state, torch.tensor(grays[1]), torch.tensor(masks[1]),
                                   torch.tensor(K), cfg, reset_depth=torch.ones((H, W)))
    assert bool(res.is_keyframe) == (branch == "promotion")
    assert {k: v for k, v in calls.items() if not k.endswith("_out")} == {
        "build_pyramid_planes": 1, "regularize_cull_pyramid": 1, "propagate": 1}
    reg_d, reg_s = calls["regularize_cull_pyramid_out"][0][-1]
    assert new.ref.base.depth is reg_d and new.ref.base.sigma is reg_s
    if branch == "promotion":
        d, s, age = calls["propagate_out"][0]
        head = new.history.head
        assert torch.equal(new.history.depth[head], d) and torch.equal(new.history.sigma[head], s)
        assert torch.equal(new.ref.base.depth, tmapper.regularize(d, s, cfg.mapper))
        assert torch.equal(new.ref.age, age) and new.history.count == 2
        assert torch.equal(new.history.gx[head], new.ref.base.gx)


# ------------------------------------------------------- bundle adjustment on
#
# The same rig with a keyframe every second frame (max_forward=2) and BA on a
# window of 3 keyframes, 3 iterations: of the three promotions in six steps
# the last two find a full window.  BA's damped solves amplify the
# twin-vs-twin float noise (tests/test_torch_ba.py: 2e-4 on the window's
# twists after three iterations), so with BA on poses are held within 1e-3,
# ``ba_window_xi`` within 1e-3, ``ba_cost`` within 1% — ``dvo_tpu``'s own
# chunked-vs-per-frame gate with BA is 2e-2 (tests/test_runner.py).

BA_CFG = dataclasses.replace(
    CFG, mapper=dataclasses.replace(CFG.mapper, max_forward=2),
    ba=dataclasses.replace(CFG.ba, enabled=True, window=3, iterations=3))
BA_TCFG = config_from_reference(BA_CFG)
BA_TOL = 1e-3


@pytest.fixture(scope="module")
def runs_ba(sequence):
    grays, masks, K = sequence
    st0 = jodo.monocular_init(jnp.asarray(grays[0]), jnp.asarray(masks[0]), jnp.asarray(K),
                              jax.random.PRNGKey(3), BA_CFG)
    stj, rj = jodo.monocular_run(st0, jnp.asarray(grays[1:]), jnp.asarray(masks[1:]),
                                 jnp.asarray(K), BA_CFG)
    sp = todo.state_from_reference(jax.tree.map(np.asarray, st0), "cpu")
    resets = torch.tensor(_reset_planes(st0.key, N - 1, BA_CFG))
    stp, rp = todo.monocular_run(sp, torch.tensor(grays[1:]), torch.tensor(masks[1:]),
                                 torch.tensor(K), BA_TCFG, reset_depths=resets)
    return (st0, stj, rj), (stp, rp), resets


def test_ba_slice_runs_ba_on_full_windows(runs_ba):
    (_, _, rj), (_, rp), _ = runs_ba
    kf = rp.is_keyframe.numpy()
    cost = rp.ba_cost.numpy()
    np.testing.assert_array_equal(kf, np.asarray(rj.is_keyframe))
    assert kf.sum() == 3
    assert np.array_equal(cost >= 0, np.asarray(rj.ba_cost) >= 0)
    assert (cost[kf] >= 0).sum() == 2 and np.all(cost[~kf] == -1.0)
    assert rp.ba_window_xi.shape == (N - 1, 3, 6)
    assert np.all(rp.ba_window_xi.numpy()[cost < 0] == 0.0)


@pytest.mark.parametrize("field", ["T_world", "relative_xi", "ba_cost", "ba_window_xi"])
def test_ba_slice_matches(runs_ba, field):
    (_, _, rj), (_, rp), _ = runs_ba
    got, want = getattr(rp, field).numpy(), np.asarray(getattr(rj, field))
    assert got.shape == want.shape
    if field == "ba_cost":
        np.testing.assert_allclose(got, want, rtol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BA_TOL)


def test_ba_slice_ring_and_reference_match(runs_ba):
    """BA's refined twists and depths land in the ring and in the new
    reference; the promoted frame's emitted pose is the refined one."""
    (_, stj, rj), (stp, rp), _ = runs_ba
    assert (stp.history.head, stp.history.count) == (int(stj.history.head), int(stj.history.count))
    np.testing.assert_array_equal(stp.history.kf_id.numpy(), np.asarray(stj.history.kf_id))
    np.testing.assert_allclose(stp.history.xi.numpy(), np.asarray(stj.history.xi), rtol=0,
                               atol=BA_TOL)
    # Depths here grow from the noise bootstrap, so many pixels are weakly
    # constrained and swing with the poses (measured: median 1.3e-5, 90% within
    # 5.5e-3, 95% within 2e-2 relative); the gate is the one tests/test_ba.py
    # holds ``dvo_tpu``'s sharded BA to, 95% within 5e-2.
    got, want = stp.history.depth.numpy(), np.asarray(stj.history.depth)
    rel = np.abs(got - want) / (1.0 + np.abs(want))
    assert np.median(rel) <= 1e-3 and np.quantile(rel, 0.95) <= 5e-2
    np.testing.assert_allclose(stp.ref.xi.numpy(), np.asarray(stj.ref.xi), rtol=0, atol=BA_TOL)
    last = int(np.flatnonzero(rp.ba_cost.numpy() >= 0)[-1])
    from dvo_tpu_torch import lie as tlie
    torch.testing.assert_close(rp.T_world[last], tlie.se3_exp(rp.ba_window_xi[last, -1]),
                               rtol=0, atol=1e-6)


def test_ba_changes_the_trajectory(runs, runs_ba):
    (_, rp_off) = runs[1]
    (_, rp_on) = runs_ba[1]
    assert rp_off.ba_window_xi.shape == (N - 1, 0, 6) and torch.all(rp_off.ba_cost == -1.0)
    assert not torch.allclose(rp_on.T_world, rp_off.T_world, atol=1e-4)


def test_ba_checkpoint_from_dvo_tpu_continues(sequence, runs_ba, tmp_path):
    """A state that ``dvo_tpu`` saved mid-run with BA on loads in the port
    and continues to ``dvo_tpu``'s poses within the BA tolerance (the ring's
    twists and depths are BA's)."""
    from dvo_tpu.utils import checkpoint as jckpt
    from dvo_tpu_torch.utils import checkpoint as tckpt

    grays, masks, K = sequence
    (st0, _, rj), _, resets = runs_ba
    cut = 4                                 # frames 1..4 seen: two promotions, one BA
    mid, _ = jodo.monocular_run(st0, jnp.asarray(grays[1:cut + 1]), jnp.asarray(masks[1:cut + 1]),
                                jnp.asarray(K), BA_CFG)
    path = str(tmp_path / "ba.npz")
    jckpt.save_state(path, mid)
    state = tckpt.load_state(path, "cpu")
    assert state.frame_count == cut + 1
    _, rest = todo.monocular_run(state, torch.tensor(grays[cut + 1:]),
                                 torch.tensor(masks[cut + 1:]), torch.tensor(K), BA_TCFG,
                                 reset_depths=resets[cut:])
    np.testing.assert_array_equal(rest.is_keyframe.numpy(), np.asarray(rj.is_keyframe)[cut:])
    assert (rest.ba_cost >= 0).any()
    np.testing.assert_allclose(rest.T_world.numpy(), np.asarray(rj.T_world)[cut:], rtol=0,
                               atol=BA_TOL)


def test_ba_step_adds_no_host_read(sequence, monkeypatch):
    """A promotion with BA reads back to the host in one copy: the keyframe
    decision with the ring's head and count (``tolist`` of one stacked
    tensor, once), which BA's window slots need."""
    grays, masks, K = sequence
    cfg = dataclasses.replace(BA_TCFG, ba=dataclasses.replace(BA_TCFG.ba, window=1),
                              mapper=dataclasses.replace(BA_TCFG.mapper, max_forward=1))
    state = todo.monocular_init(torch.tensor(grays[0]), torch.tensor(masks[0]),
                                torch.tensor(K), cfg, device="cpu", noise=torch.zeros((H, W)))
    reads = []
    for name in ("__bool__", "item", "tolist", "__int__", "__float__", "numpy", "cpu"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k: (reads.append(_n),
                                                                      _o(self, *a, **k))[1])
    _, res = todo.monocular_step(state, torch.tensor(grays[1]), torch.tensor(masks[1]),
                                 torch.tensor(K), cfg, reset_depth=torch.ones((H, W)))
    monkeypatch.undo()
    assert reads == ["tolist"], reads
    assert bool(res.is_keyframe) and float(res.ba_cost) >= 0.0
