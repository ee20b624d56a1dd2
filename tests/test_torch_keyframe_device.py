"""The monocular keyframe decision on the device: ``monocular_step`` enqueues
both mapping branches and selects them with ``torch.where`` on the device
bool ``need_kf``, with the ring's ``head``/``count`` and the frame ids as
device int32 scalars, as ``dvo_tpu``'s ``lax.cond`` step does.

Held against ``dvo_tpu.models.odometry.monocular_run`` (XLA twins) on a
sequence that promotes both by ``max_forward`` (a slow stretch) and by
motion (a fast one) and wraps the keyframe ring past its capacity of 3, at
the slice's tolerances (``tests/test_torch_odometry.py``: poses 1e-5, flags,
iterations, the ring's ``head``, ``count`` and ``kf_id`` equal, counts within
1% or 2 pixels, maps within 1e-5 on 99.5% of pixels); a ``dvo_tpu`` checkpoint
of the wrapped ring loads and continues to the same numbers; and a step
without BA reads nothing back to the host."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import DVOConfig, MapperConfig, PyramidConfig, TrackerConfig
from dvo_tpu.models import odometry as jodo
from dvo_tpu.utils import checkpoint as jckpt
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import history as thistory
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.utils import checkpoint as tckpt

from test_odometry import render_sequence
from test_torch_odometry import H, W, _reset_planes

torch.set_num_threads(1)

FINE = np.array([0.004, 0.001, 0.0007, 0.0003, -0.0007, 0.0003], np.float32)
# Frames of a finely rendered sequence: a slow stretch (each frame) and a
# fast one (every third frame).  On the noise-bootstrapped depth the tracked
# translations are about 0.0006 and 0.002 a frame, so with min_movement 0.003
# the slow stretch promotes by max_forward and the fast one by motion.
PICKS = [0, 1, 2, 3, 4, 5, 6, 7, 10, 13, 16, 19, 22, 25]
CUT = 8                     # frames 1..CUT run before the checkpoint
CFG = DVOConfig(
    pyramid=PyramidConfig(levels=2, culls=0),
    tracker=TrackerConfig(min_residual=0.0),
    mapper=MapperConfig(crop_x=(8, 72), crop_y=(6, 54), max_steps=40, max_forward=3,
                        min_movement=0.003, history_capacity=3, luminance_sigma=0.25,
                        epipolar_sigma=0.25, accept_sigma=(0.0, 2.0)),
)
TCFG = config_from_reference(CFG)


@pytest.fixture(scope="module")
def sequence():
    frames, _, K = render_sequence(np.random.default_rng(4), PICKS[-1] + 1, H, W, FINE)
    grays = np.stack([frames[i][0] for i in PICKS])
    masks = np.stack([frames[i][1] for i in PICKS])
    return grays, masks, K


@pytest.fixture(scope="module")
def runs(sequence):
    """``dvo_tpu`` in two parts (frames 1..CUT, then the rest: the state
    between them is the checkpoint), and the port step by step from the same
    first state on the same reset planes, with (head, count) after each
    step."""
    grays, masks, K = (jnp.asarray(a) for a in sequence)
    st0 = jodo.monocular_init(grays[0], masks[0], K, jax.random.PRNGKey(7), CFG)
    mid, r1 = jodo.monocular_run(st0, grays[1:CUT + 1], masks[1:CUT + 1], K, CFG)
    end, r2 = jodo.monocular_run(mid, grays[CUT + 1:], masks[CUT + 1:], K, CFG)
    want = jax.tree.map(lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)]), r1, r2)
    resets = np.concatenate([_reset_planes(st0.key, CUT, CFG),
                             _reset_planes(mid.key, len(PICKS) - 1 - CUT, CFG)])
    state = todo.state_from_reference(jax.tree.map(np.asarray, st0), "cpu")
    tg, tm, tK = (torch.tensor(a) for a in sequence)
    results, ring = [], []
    for i in range(1, len(PICKS)):
        state, res = todo.monocular_step(state, tg[i], tm[i], tK, TCFG,
                                         torch.tensor(resets[i - 1]))
        results.append(res)
        ring.append(thistory.host_ints(state.history))
    got = todo._stack(results)
    return dict(mid=mid, end=end, want=want, resets=resets, state=state, got=got, ring=ring)


def test_both_kinds_of_promotion_and_a_wrapped_ring(runs):
    """The sequence promotes by ``max_forward`` and by motion, and pushes
    more keyframes than the ring holds."""
    want = runs["want"]
    kf = np.asarray(want.is_keyframe)
    moved = np.linalg.norm(np.asarray(want.relative_xi)[:, :3], axis=1) > CFG.mapper.min_movement
    assert (kf & moved).any() and (kf & ~moved).any()
    assert kf.sum() + 1 > CFG.mapper.history_capacity
    assert (~kf).any()


def test_decisions_poses_and_stats_match(runs):
    got, want = runs["got"], runs["want"]
    np.testing.assert_array_equal(got.is_keyframe.numpy(), np.asarray(want.is_keyframe))
    assert got.is_keyframe.dtype == torch.bool
    np.testing.assert_array_equal(got.tracking.iterations.numpy(),
                                  np.asarray(want.tracking.iterations))
    np.testing.assert_allclose(got.T_world.numpy(), np.asarray(want.T_world), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.relative_xi.numpy(), np.asarray(want.relative_xi), rtol=0,
                               atol=1e-5)
    for stat in ("observed", "accepted", "rejected", "aged_out"):
        t, j = getattr(got.mapping, stat).numpy(), np.asarray(getattr(want.mapping, stat))
        assert np.all(np.abs(t - j) <= np.maximum(2, 0.01 * j)), (stat, t, j)
        assert np.all(t[got.is_keyframe.numpy()] == 0), stat


def test_ring_head_and_count_follow_the_decisions(runs):
    """After every step (head, count) is where the promotions put them, and
    the ring at the end is ``dvo_tpu``'s: head, count and ``kf_id`` equal,
    twists within 1e-5, depth and sigma within 1e-5 on 99.5% of pixels."""
    cap = CFG.mapper.history_capacity
    head, count = 0, 1
    for kf, ring in zip(np.asarray(runs["want"].is_keyframe), runs["ring"]):
        if kf:
            head, count = (head + 1) % cap, min(count + 1, cap)
        assert ring == (head, count)
    th, jh = runs["state"].history, runs["end"].history
    assert th.head.dtype == th.count.dtype == torch.int32 and th.head.dim() == 0
    assert thistory.host_ints(th) == (int(jh.head), int(jh.count))
    np.testing.assert_array_equal(th.kf_id.numpy(), np.asarray(jh.kf_id))
    np.testing.assert_allclose(th.xi.numpy(), np.asarray(jh.xi), rtol=0, atol=1e-5)
    for name in ("depth", "sigma", "gray", "gx", "gy"):
        g, w = getattr(th, name).numpy(), np.asarray(getattr(jh, name))
        assert (np.abs(g - w) <= 1e-5 * (1 + np.abs(w))).mean() >= 0.995, name
    for name in ("mask", "gmask"):
        assert (getattr(th, name).numpy() == np.asarray(getattr(jh, name))).mean() >= 0.995


def test_reference_and_frame_ids_match(runs):
    tst, jst = runs["state"], runs["end"]
    assert int(tst.frame_count) == int(jst.frame_count) == len(PICKS)
    assert int(tst.ref.frame_id) == int(jst.ref.frame_id)
    assert tst.frame_count.dtype == tst.ref.frame_id.dtype == torch.int32
    for name in ("depth", "sigma"):
        g = getattr(tst.ref.base, name).numpy()
        w = np.asarray(getattr(jst.ref.scenes[-1], name))
        assert (np.abs(g - w) <= 1e-5 * (1 + np.abs(w))).mean() >= 0.995, name
    assert (tst.ref.age.numpy() == np.asarray(jst.ref.age)).mean() >= 0.995


def test_dvo_tpu_checkpoint_of_a_wrapped_ring_continues(sequence, runs, tmp_path):
    """``dvo_tpu``'s state after CUT frames, saved by ``dvo_tpu`` and loaded
    by the port, continues to ``dvo_tpu``'s poses, decisions and ring."""
    path = str(tmp_path / "mid.npz")
    jckpt.save_state(path, runs["mid"])
    state = tckpt.load_state(path, "cpu")
    assert thistory.host_ints(state.history) == (int(runs["mid"].history.head),
                                                 int(runs["mid"].history.count))
    assert int(state.frame_count) == CUT + 1
    tg, tm, tK = (torch.tensor(a) for a in sequence)
    _, rest = todo.monocular_run(state, tg[CUT + 1:], tm[CUT + 1:], tK, TCFG,
                                 reset_depths=torch.tensor(runs["resets"][CUT:]))
    want = runs["want"]
    np.testing.assert_array_equal(rest.is_keyframe.numpy(), np.asarray(want.is_keyframe)[CUT:])
    np.testing.assert_allclose(rest.T_world.numpy(), np.asarray(want.T_world)[CUT:], rtol=0,
                               atol=1e-5)
    # ... and the port's own checkpoint of the end state holds int32 scalars.
    out = str(tmp_path / "end.npz")
    tckpt.save_state(out, runs["state"])
    with np.load(out) as data:
        for key in ("history/head", "history/count", "frame_count", "ref/frame_id"):
            assert data[key].dtype == np.int32 and data[key].shape == (), key


@pytest.mark.parametrize("branch", ["promotion", "depth_update"])
def test_step_without_ba_reads_nothing_back(branch, sequence, monkeypatch):
    """``monocular_step`` without BA calls no ``bool``/``int``/``float``/
    ``item``/``tolist``/``numpy``/``cpu`` on a tensor in either branch: the
    decision stays on the device."""
    grays, masks, K = (torch.tensor(a) for a in sequence)
    cfg = dataclasses.replace(TCFG, mapper=dataclasses.replace(
        TCFG.mapper, max_forward=1 if branch == "promotion" else 50, min_movement=1e9))
    state = todo.monocular_init(grays[0], masks[0], K, cfg, device="cpu",
                                noise=torch.zeros((H, W)))
    reads = []
    for name in ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "numpy",
                 "cpu"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k: (reads.append(_n),
                                                                      _o(self, *a, **k))[1])
    new, res = todo.monocular_step(state, grays[1], masks[1], K, cfg,
                                   reset_depth=torch.ones((H, W)))
    todo.monocular_step(new, grays[2], masks[2], K, cfg, reset_depth=torch.ones((H, W)))
    monkeypatch.undo()
    assert reads == [], reads
    assert bool(res.is_keyframe) == (branch == "promotion")


def test_reset_plane_is_drawn_on_every_frame(sequence):
    """Without reset planes the state's generator advances once per frame,
    promotion or not (``dvo_tpu`` splits its key on every frame)."""
    grays, masks, K = (torch.tensor(a) for a in sequence)
    cfg = dataclasses.replace(TCFG, mapper=dataclasses.replace(TCFG.mapper, max_forward=1))
    gen = torch.Generator().manual_seed(3)
    state = todo.monocular_init(grays[0], masks[0], K, cfg, device="cpu",
                                noise=torch.zeros((H, W)), generator=gen)
    _, res = todo.monocular_run(state, grays[1:3], masks[1:3], K, cfg)
    assert bool(res.is_keyframe.all())
    twin = torch.Generator().manual_seed(3)
    for _ in range(2):
        torch.rand((H, W), generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())


@pytest.mark.parametrize("flag", [True, False])
def test_select_frame_on_the_kernel_layout(flag, monkeypatch):
    """``select_frame`` of two frames whose planes are views into one buffer
    per plane kind (the frame-build kernel's layout, here through its NumPy
    transcription): one ``where`` per buffer, and per-level views that equal
    the chosen frame's planes and again share one buffer."""
    from dvo_tpu_torch.models import frame as tframe
    from dvo_tpu_torch.ops.cuda import _build
    from dvo_tpu_torch.ops.cuda import framebuild as tfb
    from test_torch_framebuild import _EmulatedLibrary, _inputs

    monkeypatch.setattr(tfb, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(tframe, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", lambda: _EmulatedLibrary())
    monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
    frames = []
    for seed in (1, 2):
        gray, mask, _, _ = (torch.from_numpy(x) for x in _inputs(seed, 20, 28))
        f = tframe.build_tracking_frame(gray, mask, torch.eye(3), 3, 0, 4 + seed)
        frames.append(dataclasses.replace(f, xi=torch.full((6,), float(seed))))
    a, b = frames
    assert tframe._one_buffer([s.gray for s in a.scenes]) is not None
    got = tframe.select_frame(torch.tensor(flag), a, b)
    want = a if flag else b
    for g, w in zip(got.scenes, want.scenes):
        for name in ("gray", "mask", "gx", "gy", "gmask", "K"):
            assert torch.equal(getattr(g, name), getattr(w, name)), name
        assert g.depth is None and g.sigma is None
    assert tframe._one_buffer([s.gx for s in got.scenes]) is not None
    assert torch.equal(got.xi, want.xi) and int(got.frame_id) == int(want.frame_id)
