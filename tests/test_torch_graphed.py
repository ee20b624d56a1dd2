"""The graphed step driver (``dvo_tpu_torch/models/graphed.py``) on the CPU,
where it runs its protocol (load, step, copy back, copy out) without
capture: it must equal the eager step loop bitwise, its copy-back must
cover every tensor of a state, the drivers must be cached along a run, and
``cfg.ba.enabled`` must take the eager loop."""

import dataclasses

import numpy as np
import pytest
import torch

from dvo_tpu.config import DVOConfig, MapperConfig, PyramidConfig, TrackerConfig
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import graphed
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.models.frame import Scene
from dvo_tpu_torch.models.history import KeyframeHistory, host_ints

from test_odometry import render_sequence

torch.set_num_threads(1)

H, W, N = 48, 64, 9
# A 3-slot ring and a keyframe every third frame at most: the sequence
# promotes several times and wraps the ring; the looser depth-filter bands
# let the updates between promotions accept observations.
CFG = config_from_reference(DVOConfig(
    pyramid=PyramidConfig(levels=2, culls=0),
    tracker=TrackerConfig(min_residual=0.0),
    mapper=MapperConfig(crop_x=(6, W - 8), crop_y=(5, H - 6), max_steps=24, max_forward=2,
                        history_capacity=3, luminance_sigma=0.25, epipolar_sigma=0.25,
                        accept_sigma=(0.0, 2.0)),
))
RGBD_CFG = dataclasses.replace(config_from_reference(DVOConfig.rgbd()),
                               pyramid=PyramidConfig(levels=2, culls=0))


def same(a, b) -> bool:
    la, lb = graphed.leaves(a), graphed.leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def sequence():
    frames, depth0, K = render_sequence(np.random.default_rng(4), N + 1, H, W,
                                        np.array([0.012, 0.003, 0.002, 0.001, -0.002, 0.001],
                                                 np.float32))
    grays = torch.tensor(np.stack([f[0] for f in frames]))
    masks = torch.tensor(np.stack([f[1] for f in frames]))
    resets = torch.clamp(0.5 + 1.5 * torch.rand((N, H, W),
                                                 generator=torch.Generator().manual_seed(2)),
                         max=4.0)
    return grays, masks, torch.tensor(K), torch.tensor(depth0), resets


def _mono_init(seq, seed=3):
    grays, masks, K, _, _ = seq
    noise = torch.randn((H, W), generator=torch.Generator().manual_seed(1))
    return todo.monocular_init(grays[0], masks[0], K, CFG, device="cpu", noise=noise,
                               generator=torch.Generator().manual_seed(seed))


def _eager_mono(state, seq, sl, with_resets):
    grays, masks, K, _, resets = seq
    g, m = grays[1:][sl], masks[1:][sl]
    r = resets[sl]
    return todo._eager_run(state, g.shape[0], lambda st, i: todo.monocular_step(
        st, g[i], m[i], K, CFG, r[i] if with_resets else None))


def _rgbd_inputs(seq):
    grays, masks, K, depth0, _ = seq
    depths = torch.stack([depth0 - 0.002 * k for k in range(N + 1)])
    sigmas = torch.full_like(depths, 0.1)
    state = todo.rgbd_init(grays[0], masks[0], depths[0], sigmas[0], K, RGBD_CFG, device="cpu")
    return state, (grays[1:], masks[1:], depths[1:], sigmas[1:]), K


@pytest.mark.parametrize("planes", ["passed", "drawn"])
def test_mono_driver_equals_eager_step_loop(sequence, planes):
    """Two chunks through the driver (the second reusing the first's) equal
    the eager step loop bitwise: results and end state; the run promotes
    and wraps the 3-slot ring, and updates depth in between."""
    with_resets = planes == "passed"
    grays, masks, K, _, resets = sequence
    chunks = (slice(0, 4), slice(4, N))
    st_d, st_e, res_d, res_e = _mono_init(sequence), _mono_init(sequence), [], []
    for sl in chunks:
        st_d, r = todo.monocular_run(st_d, grays[1:][sl], masks[1:][sl], K, CFG,
                                     resets[sl] if with_resets else None)
        res_d.append(r)
        st_e, r = _eager_mono(st_e, sequence, sl, with_resets)
        res_e.append(r)
    assert all(same(a, b) for a, b in zip(res_d, res_e))
    assert same(st_d, st_e)
    assert st_d.generator.get_state().equal(st_e.generator.get_state())
    kf = torch.cat([r.is_keyframe for r in res_d])
    head, count = host_ints(st_d.history)
    assert kf.sum() > CFG.mapper.history_capacity and count == CFG.mapper.history_capacity
    assert (torch.cat([r.mapping.accepted for r in res_d])[~kf] > 0).any()


def test_rgbd_driver_equals_eager_step_loop(sequence):
    state, (g, m, d, s), K = _rgbd_inputs(sequence)
    st_d, res_d = todo.rgbd_run(state, g, m, d, s, K, RGBD_CFG)
    st_e, res_e = todo._eager_run(state, N, lambda st, i: todo.rgbd_step(
        st, g[i], m[i], d[i], s[i], K, RGBD_CFG))
    assert same(res_d, res_e) and same(st_d, st_e)


def _sentinel(tree):
    """``tree`` with every tensor overwritten by a value no step writes."""
    for t in graphed.leaves(tree):
        t.fill_(True if t.dtype == torch.bool else -7)
    return tree


@pytest.mark.parametrize("kind", ["mono", "rgbd"])
@pytest.mark.parametrize("layout", ["per_level", "one_buffer"])
def test_copy_back_covers_every_tensor(sequence, kind, layout):
    """After one step, the copy-back (``state_pairs`` + ``copy_pairs``) into
    a static state filled with a sentinel leaves no tensor of it unwritten:
    every tensor of VOState / RGBDState, with the new state's planes one
    tensor per level (the CPU's build) or one buffer per kind (the card's)."""
    grays, masks, K, _, resets = sequence
    if kind == "mono":
        state = _mono_init(sequence)
        new, _ = todo.monocular_step(state, grays[1], masks[1], K, CFG, resets[0])
    else:
        state, (g, m, d, s), K = _rgbd_inputs(sequence)
        new, _ = todo.rgbd_step(state, g[0], m[0], d[0], s[0], K, RGBD_CFG)
    if layout == "one_buffer":
        new = graphed.clone_state(new)
    static = _sentinel(graphed.clone_state(state))
    graphed.copy_pairs(graphed.state_pairs(static, new))
    assert same(static, new)
    # ... and the sentinel reached every tensor field of the state: none of
    # them is None on a state, so none can be missed by the walk.
    tensor_fields = {f.name for f in dataclasses.fields(Scene)} | {
        "xi", "relative_xi", "age", "frame_id", "frame_count", "vel"}
    if kind == "mono":
        tensor_fields |= {f.name for f in dataclasses.fields(KeyframeHistory)} | {"prev_rel"}
    reached = set()

    def walk(tree):
        if isinstance(tree, tuple):
            for x in tree:
                walk(x)
        elif dataclasses.is_dataclass(tree):
            for f in dataclasses.fields(tree):
                value = getattr(tree, f.name)
                if isinstance(value, torch.Tensor):
                    reached.add(f.name)
                walk(value)

    walk(static)
    assert reached == tensor_fields


@pytest.mark.parametrize("order", ["count_first", "frame_id_first"])
def test_copy_back_reads_every_source_before_writing(order):
    """The copy-back's sources are read before any destination is written,
    whatever the order of the pairs: a step's new reference frame id is the
    old frame count, which the same copy overwrites with the count + 1 (on
    the card one foreach copy writes its tensors in no fixed order)."""
    count = torch.tensor(7, dtype=torch.int32)
    frame_id = torch.tensor(0, dtype=torch.int32)
    pairs = [(count, count + 1), (frame_id, count)]
    graphed.copy_pairs(pairs if order == "count_first" else pairs[::-1])
    assert int(count) == 8 and int(frame_id) == 7


def test_state_layout_change_raises(sequence):
    state = _mono_init(sequence)
    other = dataclasses.replace(state, vel=torch.zeros(5))
    with pytest.raises(ValueError, match="layout"):
        graphed.state_pairs(state, other)


def test_returned_state_is_a_copy_and_drivers_are_cached(sequence):
    """The state a chunk returns shares no storage with the driver's static
    state (a later replay cannot change it); the next chunk from it, and a
    state carried over from it, reuse its drivers; a fresh state gets new
    ones."""
    grays, masks, K, _, resets = sequence
    st0 = _mono_init(sequence)
    st1, _ = todo.monocular_run(st0, grays[1:4], masks[1:4], K, CFG, resets[:3])
    drivers = graphed.drivers_of(st1)
    assert drivers is not None and graphed.drivers_of(st0) == drivers
    static = {t.untyped_storage().data_ptr() for t in graphed.leaves(drivers[0].state)}
    assert not static & {t.untyped_storage().data_ptr() for t in graphed.leaves(st1)}
    kept = [t.clone() for t in graphed.leaves(st1)]
    st2, _ = todo.monocular_run(st1, grays[4:7], masks[4:7], K, CFG, resets[3:6])
    assert graphed.drivers_of(st2) == drivers
    assert all(torch.equal(a, b) for a, b in zip(kept, graphed.leaves(st1)))
    corrected = dataclasses.replace(st2, vel=st2.vel * 0)
    graphed.carry(corrected, st2)
    st3, _ = todo.monocular_run(corrected, grays[7:9], masks[7:9], K, CFG, resets[6:8])
    assert graphed.drivers_of(st3) == drivers
    fresh, _ = todo.monocular_run(_mono_init(sequence), grays[1:4], masks[1:4], K, CFG,
                                  resets[:3])
    assert graphed.drivers_of(fresh)[0] is not drivers[0]
    # another input layout (a shared mask) is another captured step
    other, _ = todo.monocular_run(st1, grays[4:7], masks[0], K, CFG, resets[3:6])
    assert graphed.drivers_of(other)[0].key != drivers[0].key


def test_ba_takes_the_eager_loop(sequence, monkeypatch):
    """With cfg.ba.enabled the chunk runs ``_eager_run`` (its step reads the
    ring's head and count to the host) and never the driver; without BA it
    runs the driver and never the eager loop."""
    grays, masks, K, _, resets = sequence
    calls = []
    eager = todo._eager_run
    monkeypatch.setattr(todo, "_eager_run", lambda *a: calls.append("eager") or eager(*a))
    run = graphed.run
    monkeypatch.setattr(graphed, "run", lambda *a, **k: calls.append("graphed") or run(*a, **k))
    cfg_ba = dataclasses.replace(CFG, ba=dataclasses.replace(CFG.ba, enabled=True, window=2,
                                                             iterations=1))
    _, res = todo.monocular_run(_mono_init(sequence), grays[1:5], masks[1:5], K, cfg_ba,
                                resets[:4])
    assert calls == ["eager"] and res.ba_window_xi.shape == (4, 2, 6)
    assert (res.ba_cost >= 0).any()
    calls.clear()
    todo.monocular_run(_mono_init(sequence), grays[1:5], masks[1:5], K, CFG, resets[:4])
    assert calls == ["graphed"]
    calls.clear()
    states = todo.stack_states([_mono_init(sequence)] * 2)
    todo.monocular_run_batched(states, torch.stack([grays[1:4]] * 2),
                               torch.stack([masks[1:4]] * 2), K, cfg_ba,
                               torch.stack([resets[:3]] * 2))
    assert calls == ["eager", "eager"]
