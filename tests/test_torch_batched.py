"""The multi-stream mode, mirroring ``tests/test_batched.py``: the port's
``monocular_init_batched`` + ``monocular_run_batched`` against
``dvo_tpu``'s on the same frames, with the bootstrap noise and the reset
planes that ``dvo_tpu`` draws from its split keys injected into the port
(the pattern of ``test_torch_odometry.py``).

Tolerances: world poses within rtol 1e-5, atol 1e-6 (``test_batched.py``'s
bound for a stream against its own run; the twins differ by float noise);
keyframe flags and GN iteration counts equal; state leaves within 1e-5.
Each stream of the port's batched run equals its own single-stream run at
tolerance 0, and draws what a single-stream run with its generator draws."""

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
from dvo_tpu_torch.models.graphed import leaves

from test_odometry import render_sequence

torch.set_num_threads(1)

H, W, N, B = 48, 64, 5, 3
CFG = DVOConfig(
    pyramid=PyramidConfig(levels=2, culls=0),
    tracker=TrackerConfig(min_residual=0.0),
    mapper=MapperConfig(crop_x=(6, W - 8), crop_y=(5, H - 6), max_steps=24, max_forward=3,
                        luminance_sigma=0.25, epipolar_sigma=0.25, accept_sigma=(0.0, 2.0)),
)
TCFG = config_from_reference(CFG)
KEY = jax.random.PRNGKey(7)


def _sequences(rng):
    """B sequences of N + 1 frames, stream s moving at its own speed."""
    seqs, K = [], None
    for s in range(B):
        step = np.array([0.01 + 0.002 * s, 0.002, -0.004, 0.001, 0.001, 0], np.float32)
        frames, _, K = render_sequence(rng, N + 1, H, W, step)
        seqs.append(np.stack([f[0] for f in frames]))
    return np.stack(seqs), K


def _draws(keys, cfg):
    """What dvo_tpu's batched init and run draw, per stream: the bootstrap
    noise (monocular_init: key -> (key, sub), normal(sub)) and the reset
    plane of each frame (monocular_step: key -> (key, k_frame, k_reset))."""
    lo, hi = cfg.mapper.depth_filter.reset_depth_range
    noise, resets = [], []
    for key in keys:
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (H, W))))
        planes = []
        for _ in range(N):
            key, _, k_reset = jax.random.split(key, 3)
            u = jax.random.uniform(k_reset, (H, W), minval=lo, maxval=hi)
            planes.append(np.asarray(jnp.minimum(u, cfg.mapper.depth_filter.reset_depth_cap)))
        resets.append(np.stack(planes))
    return np.stack(noise), np.stack(resets)


def _port(grays, K, noise, resets, cfg=TCFG):
    masks = torch.ones(grays.shape, dtype=torch.bool)
    st0 = todo.monocular_init_batched(grays[:, 0], masks[:, 0], K, cfg, device="cpu",
                                      noise=noise)
    st, res = todo.monocular_run_batched(st0, grays[:, 1:], masks[:, 1:], K, cfg, resets)
    return st0, st, res


@pytest.fixture(scope="module")
def runs():
    grays, K = _sequences(np.random.default_rng(0))
    masks = jnp.ones(grays.shape, bool)
    j0 = jodo.monocular_init_batched(jnp.asarray(grays[:, 0]), masks[:, 0], jnp.asarray(K), KEY,
                                     CFG)
    jst, jres = jodo.monocular_run_batched(j0, jnp.asarray(grays[:, 1:]), masks[:, 1:],
                                           jnp.asarray(K), CFG)
    noise, resets = _draws(jax.random.split(KEY, B), CFG)
    t = dict(grays=torch.tensor(grays), K=torch.tensor(K), noise=torch.tensor(noise),
             resets=torch.tensor(resets))
    t0, tst, tres = _port(t["grays"], t["K"], t["noise"], t["resets"])
    return dict(j0=jax.tree.map(np.asarray, j0), jst=jax.tree.map(np.asarray, jst), jres=jres,
                t0=t0, tst=tst, tres=tres, inputs=t)


def test_batched_run_exercises_both_branches(runs):
    kf = runs["tres"].is_keyframe.numpy()
    assert kf.shape == (B, N)
    assert kf.any() and (~kf).any()
    assert (runs["tres"].mapping.accepted.numpy()[~kf] > 0).any()


@pytest.mark.parametrize("field", ["T_world", "relative_xi"])
def test_batched_matches_dvo_tpu(runs, field):
    got, want = getattr(runs["tres"], field).numpy(), np.asarray(getattr(runs["jres"], field))
    assert got.shape[:2] == (B, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("field", ["is_keyframe", "iterations"])
def test_batched_decisions_match_dvo_tpu(runs, field):
    res, jres = runs["tres"], runs["jres"]
    get = (lambda r: r.is_keyframe) if field == "is_keyframe" else (lambda r: r.tracking.iterations)
    np.testing.assert_array_equal(get(res).numpy(), np.asarray(get(jres)))


@pytest.mark.parametrize("which", ["init", "end"])
def test_batched_state_matches_dvo_tpu_leaves(runs, which):
    """The port's stack of states against dvo_tpu's batched state, leaf by
    leaf (state_to_numpy keeps the leading B axis)."""
    got = todo.state_to_numpy(runs["t0" if which == "init" else "tst"])
    want = runs["j0" if which == "init" else "jst"]
    for name in ("frame_count",):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("head", "count", "kf_id"):
        np.testing.assert_array_equal(getattr(got.history, name), getattr(want.history, name))
    np.testing.assert_array_equal(got.ref.frame_id, want.ref.frame_id)
    for name in ("gray", "mask", "xi"):
        np.testing.assert_allclose(getattr(got.history, name), getattr(want.history, name),
                                   rtol=0, atol=1e-5)
    for g, w in zip(got.ref.scenes, want.ref.scenes):
        for name in ("gray", "mask", "depth", "sigma"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.shape == b.shape and a.shape[0] == B
            ok = np.abs(a.astype(np.float32) - b.astype(np.float32)) <= 1e-5 * (1 + np.abs(b))
            assert ok.mean() >= 0.995, (name, ok.mean())
    np.testing.assert_allclose(got.prev_rel, want.prev_rel, rtol=0, atol=1e-5)


def test_batched_state_from_dvo_tpu_continues_equally(runs):
    """dvo_tpu's batched init state, converted by state_from_reference on the
    batched layout, continues as dvo_tpu's run does."""
    t = runs["inputs"]
    st = todo.state_from_reference(runs["j0"], "cpu")
    assert st.history.capacity == CFG.mapper.history_capacity
    assert st.frame_count.shape == (B,) and len(st.generator) == B
    masks = torch.ones(t["grays"].shape, dtype=torch.bool)
    _, res = todo.monocular_run_batched(st, t["grays"][:, 1:], masks[:, 1:], t["K"], TCFG,
                                        t["resets"])
    np.testing.assert_allclose(res.T_world.numpy(), np.asarray(runs["jres"].T_world),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stream", range(B))
def test_each_stream_equals_its_single_run(runs, stream):
    """Tolerance 0: stream s of the batched run against monocular_init +
    monocular_run of stream s alone, results and end state."""
    t = runs["inputs"]
    g = t["grays"][stream]
    mask = torch.ones(g.shape[1:], dtype=torch.bool)
    st = todo.monocular_init(g[0], mask, t["K"], TCFG, device="cpu", noise=t["noise"][stream])
    st, res = todo.monocular_run(st, g[1:], mask, t["K"], TCFG, t["resets"][stream])
    for a, b in zip(leaves(res), leaves(todo.select_streams(runs["tres"], stream))):
        assert torch.equal(a, b)
    for a, b in zip(leaves(st), leaves(todo.select_streams(runs["tst"], stream))):
        assert torch.equal(a, b)


def test_batched_per_stream_intrinsics():
    """A (B, 3, 3) K batches per-stream intrinsics, against dvo_tpu's."""
    grays, K = _sequences(np.random.default_rng(1))
    Ks = np.stack([K * np.array([[1.0 + 0.05 * s], [1.0 + 0.05 * s], [1.0]], np.float32)
                   for s in range(B)])
    masks = jnp.ones(grays.shape, bool)
    j0 = jodo.monocular_init_batched(jnp.asarray(grays[:, 0]), masks[:, 0], jnp.asarray(Ks), KEY,
                                     CFG)
    _, jres = jodo.monocular_run_batched(j0, jnp.asarray(grays[:, 1:]), masks[:, 1:],
                                         jnp.asarray(Ks), CFG)
    noise, resets = _draws(jax.random.split(KEY, B), CFG)
    _, _, tres = _port(torch.tensor(grays), torch.tensor(Ks), torch.tensor(noise),
                       torch.tensor(resets))
    T = tres.T_world.numpy()
    np.testing.assert_allclose(T, np.asarray(jres.T_world), rtol=1e-5, atol=1e-6)
    assert not np.allclose(T[0], T[1])


def test_stream_draws_equal_single_generator_runs(runs):
    """Without injected planes each stream draws its noise and reset planes
    from its own generator (stream_generators: distinct seeds), exactly as a
    single-stream run handed a generator seeded the same does."""
    t = runs["inputs"]
    masks = torch.ones(t["grays"].shape, dtype=torch.bool)
    st0 = todo.monocular_init_batched(t["grays"][:, 0], masks[:, 0], t["K"], TCFG, device="cpu",
                                      generators=todo.stream_generators("cpu", B, seed=5))
    _, res = todo.monocular_run_batched(st0, t["grays"][:, 1:], masks[:, 1:], t["K"], TCFG)
    seeds = {g.initial_seed() for g in todo.stream_generators("cpu", B, seed=5)}
    assert len(seeds) == B
    for s in range(B):
        gen = todo.stream_generators("cpu", B, seed=5)[s]
        st = todo.monocular_init(t["grays"][s, 0], masks[s, 0], t["K"], TCFG, device="cpu",
                                 generator=gen)
        _, one = todo.monocular_run(st, t["grays"][s, 1:], masks[s, 1:], t["K"], TCFG)
        for a, b in zip(leaves(one), leaves(todo.select_streams(res, s))):
            assert torch.equal(a, b)
    # stream b's generator does not depend on how many streams there are
    assert (todo.stream_generators("cpu", 1, 5)[0].initial_seed()
            == todo.stream_generators("cpu", B, 5)[0].initial_seed())


def test_batched_state_round_trip(runs):
    """state_to_numpy -> state_from_reference of a stack of states gives the
    same tensors back; stack_states and unstack_states invert each other."""
    st = runs["tst"]
    back = todo.state_from_reference(todo.state_to_numpy(st), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(st)))
    again = todo.stack_states(todo.unstack_states(st))
    assert all(torch.equal(a, b) for a, b in zip(leaves(again), leaves(st)))
    assert again.generator == st.generator


def test_rgbd_batched_equals_single_runs():
    """rgbd_run_batched: each stream equal to its own rgbd_run (tolerance 0),
    K shared."""
    rng = np.random.default_rng(2)
    cfg = config_from_reference(DVOConfig.rgbd())
    cfg = dataclasses.replace(cfg, pyramid=dataclasses.replace(cfg.pyramid, levels=2, culls=0))
    grays, K = _sequences(rng)
    grays, K = torch.tensor(grays), torch.tensor(K)
    masks = torch.ones(grays.shape, dtype=torch.bool)
    depths = torch.full(grays.shape, 1.5) + 0.01 * torch.arange(B).view(B, 1, 1, 1)
    sigmas = torch.full(grays.shape, 0.1)
    singles = [todo.rgbd_init(grays[s, 0], masks[s, 0], depths[s, 0], sigmas[s, 0], K, cfg,
                              device="cpu") for s in range(B)]
    st, res = todo.rgbd_run_batched(todo.stack_states(singles), grays[:, 1:], masks[:, 1:],
                                    depths[:, 1:], sigmas[:, 1:], K, cfg)
    assert res.T_world.shape == (B, N, 4, 4)
    for s in range(B):
        one_st, one = todo.rgbd_run(singles[s], grays[s, 1:], masks[s, 1:], depths[s, 1:],
                                    sigmas[s, 1:], K, cfg)
        assert all(torch.equal(a, b) for a, b in zip(leaves(one),
                                                     leaves(todo.select_streams(res, s))))
        assert all(torch.equal(a, b) for a, b in zip(leaves(one_st),
                                                     leaves(todo.select_streams(st, s))))
