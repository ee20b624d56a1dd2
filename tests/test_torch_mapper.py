"""The port's mapper against ``dvo_tpu.models.mapper``: keyframe policy,
propagate, the keyframe ring, the regulariser's plain version and the
epipolar depth update (plain torch preparation + the plain version beside
the CUDA kernel) with the same injected reset plane.

Tolerances, from the measured twin-vs-twin spread: counts, ages, slots and
flags exact; depth and sigma maps within 1e-5 (relative + absolute) on at
least 99.5% of pixels — an observation whose SSD argmin or strict gate
sits within float noise may flip between XLA and PyTorch — and the
depth-update counts within 1% (or 2 pixels)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu import lie as jlie
from dvo_tpu.config import MapperConfig
from dvo_tpu.models import history as jhistory
from dvo_tpu.models import mapper as jmapper
from dvo_tpu.models.frame import build_frame_with_depth
from dvo_tpu.ops.warp import warp_image
from dvo_tpu_torch.models import history as thistory
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import mapper as tmapper
from dvo_tpu_torch.models.odometry import frame_from_reference
from dvo_tpu_torch.ops.cuda import epipolar, regularize

from test_image_ops import smooth_image
from test_mapper import sharp_image

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_maps_close(got, want, share=0.995):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ok = np.abs(got - want) <= 1e-5 * (1.0 + np.abs(want))
    assert ok.mean() >= share, (ok.mean(), np.abs(got - want).max())


@pytest.mark.parametrize("rel,frame_id,ref_id", [
    ([0.01, 0, 0, 0, 0, 0], 3, 0), ([0.03, 0, 0, 0, 0, 0], 1, 0),
    ([0.01, 0, 0, 0, 0, 0], 6, 0), ([0.0, 0.015, 0.015, 0.3, 0, 0], 9, 8),
])
def test_need_new_keyframe_matches(rel, frame_id, ref_id):
    rel = np.asarray(rel, np.float32)
    cfg = MapperConfig()
    assert bool(tmapper.need_new_keyframe(_t(rel), frame_id, ref_id,
                                          config_from_reference(cfg))) == bool(
        jmapper.need_new_keyframe(jnp.asarray(rel), frame_id, ref_id, cfg))


@pytest.mark.parametrize("focal,xi", [
    (25.0, [0.01, -0.01, 0.02, 0, 0, 0]),               # few collisions
    (4.0, [0.05, 0.02, 0.1, 0, 0, 0]),                  # wide lens: many collisions
    (30.0, [0.02, 0.0, -0.03, 0.01, -0.02, 0.01]),      # rotation, moving back
])
def test_propagate_matches(rng, focal, xi):
    """Whole maps, collisions included: both resolve them to the nearest
    source, ties by raster id (images under 32768 pixels)."""
    h, w = 24, 32
    depth = (1.0 + 0.5 * smooth_image(rng, h, w)).astype(np.float32)
    depth[0, :4] = 0.0
    sigma = (0.2 + 0.1 * smooth_image(rng, h, w)).astype(np.float32)
    age = rng.integers(0, 3, (h, w)).astype(np.int32)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    xi = np.asarray(xi, np.float32)
    jd, js, ja = jmapper.propagate(*(jnp.asarray(a) for a in (depth, sigma, age, xi, K)))
    td, ts, ta = tmapper.propagate(*(_t(a) for a in (depth, sigma, age, xi, K)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spread", [0.1, 1.0, 4.0])
def test_regularize_plain_matches(rng, spread):
    """Neighbours inside and outside the compatibility gate, and depths
    past the 6 m clamp."""
    h, w = 20, 24
    depth = (1.0 + spread * rng.random((h, w))).astype(np.float32)
    depth[3, 3] = 7.0
    sigma = (0.05 + 0.45 * rng.random((h, w))).astype(np.float32)
    j = jmapper.regularize(jnp.asarray(depth), jnp.asarray(sigma))
    t = regularize.regularize_plain(_t(depth), _t(sigma),
                                    config_from_reference(MapperConfig()))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def _scene_data(rng, h, w):
    img = sharp_image(rng, h, w)
    depth = (1.4 + 0.4 * smooth_image(rng, h, w)).astype(np.float32)
    K = np.array([[2.0 * w, 0, w / 2], [0, 2.0 * w, h / 2], [0, 0, 1]], np.float32)
    return img, depth, K


def _render(img, depth, K, xi):
    g, m = warp_image(jnp.asarray(xi, jnp.float32), jnp.asarray(img),
                      jnp.ones(img.shape, bool), jnp.asarray(depth), jnp.asarray(K))
    return np.asarray(g), np.asarray(m)


def _ring(rng, h, w, poses, capacity=4):
    """A dvo_tpu keyframe ring holding keyframes rendered at ``poses``
    (world twists), newest last; returns (history, img, depth, K)."""
    img, depth, K = _scene_data(rng, h, w)
    hist = jhistory.KeyframeHistory.create(capacity, h, w)
    for fid, xi in enumerate(poses):
        g, m = _render(img, depth, K, xi)
        f = build_frame_with_depth(jnp.asarray(g), jnp.asarray(m), jnp.asarray(depth),
                                   jnp.full((h, w), 0.3, jnp.float32), jnp.asarray(K),
                                   levels=1, culls=0, frame_id=fid)
        hist = jhistory.push(hist, dataclasses.replace(f, xi=jnp.asarray(xi, jnp.float32)))
    return hist, img, depth, K


def _port_history(hist):
    h = jax.tree.map(np.asarray, hist)
    return thistory.KeyframeHistory(
        **{k: _t(getattr(h, k)) for k in ("gray", "mask", "gx", "gy", "gmask", "depth",
                                          "sigma", "xi", "kf_id")},
        head=int(h.head), count=int(h.count))


def test_history_push_refresh_and_born_slot(rng):
    """Six pushes into a 4-slot ring (wrap-around), a head refresh, and
    the born-slot lookup for ages past the live window."""
    poses = [[0.01 * k, 0, 0, 0, 0, 0] for k in range(6)]
    jh, img, depth, K = _ring(rng, 12, 16, poses, capacity=4)
    th = _port_history(jh)
    assert (th.head, th.count) == (int(jh.head), int(jh.count)) == (1, 4)
    age = rng.integers(0, 7, (12, 16)).astype(np.int32)
    np.testing.assert_array_equal(thistory.born_slot(th, _t(age)).numpy(),
                                  np.asarray(jhistory.born_slot(jh, jnp.asarray(age))))

    f = build_frame_with_depth(jnp.asarray(img), jnp.ones((12, 16), bool), jnp.asarray(depth),
                               jnp.full((12, 16), 0.2, jnp.float32), jnp.asarray(K), 1, 0, 9)
    f = dataclasses.replace(f, xi=jnp.full((6,), 0.01, jnp.float32))
    tf = frame_from_reference(jax.tree.map(np.asarray, f), "cpu")
    j2 = jhistory.push(jhistory.refresh_head(jh, f), f)
    t2 = thistory.push(thistory.refresh_head(th, tf), tf)
    assert (t2.head, t2.count) == (int(j2.head), int(j2.count))
    for k in ("gray", "mask", "gx", "gy", "gmask", "depth", "sigma", "xi", "kf_id"):
        np.testing.assert_array_equal(getattr(t2, k).numpy(), np.asarray(getattr(j2, k)), err_msg=k)
    # The ring is copied, not written in place: the older state is intact.
    np.testing.assert_array_equal(th.kf_id.numpy(), np.asarray(jh.kf_id))


def _depth_update_case(rng, h, w, poses, obj_xi, ages, cfg):
    jh, img, depth, K = _ring(rng, h, w, poses)
    ref_xi = np.asarray(poses[-1], np.float32)
    obj_xi = np.asarray(obj_xi, np.float32)
    rel = np.asarray(jlie.compose(-jnp.asarray(ref_xi), jnp.asarray(obj_xi)))
    g, m = _render(img, depth, K, obj_xi)
    obj_frame = build_frame_with_depth(jnp.asarray(g), jnp.asarray(m), jnp.asarray(depth),
                                       jnp.full((h, w), 0.5, jnp.float32), jnp.asarray(K),
                                       levels=1, culls=0, frame_id=len(poses))
    obj = obj_frame.scenes[0]
    prior = np.clip(depth + rng.normal(0, 0.15, (h, w)), 0.3, None).astype(np.float32)
    sigma = np.full((h, w), 0.3, np.float32)
    age = ages(rng, h, w)
    key = jax.random.PRNGKey(11)
    lo, hi = cfg.depth_filter.reset_depth_range
    reset = np.minimum(np.asarray(jax.random.uniform(key, (h, w), minval=lo, maxval=hi)),
                       cfg.depth_filter.reset_depth_cap)
    jout = jmapper.depth_update(obj, jnp.asarray(obj_xi), jnp.asarray(rel), jnp.asarray(prior),
                                jnp.asarray(sigma), jnp.asarray(age), jh, key, cfg)
    tobj = frame_from_reference(jax.tree.map(np.asarray, obj_frame), "cpu").scenes[0]
    tout = tmapper.depth_update(tobj, _t(obj_xi), _t(rel), _t(prior), _t(sigma), _t(age),
                                _port_history(jh), _t(reset), config_from_reference(cfg))
    return jout, tout


CFG = MapperConfig(crop_x=(4, 76), crop_y=(4, 56), max_steps=40,
                   luminance_sigma=0.25, epipolar_sigma=0.25)
TCFG = config_from_reference(CFG)


@pytest.mark.parametrize("poses,obj_xi,ages", [
    # one keyframe, the object 10 cm to the side
    ([[0, 0, 0, 0, 0, 0]], [-0.1, 0, 0, 0, 0, 0], lambda r, h, w: np.zeros((h, w), np.int32)),
    # three keyframes, per-pixel born ages 0..3 (3 = aged out of a 3-deep ring)
    ([[0, 0, 0, 0, 0, 0], [-0.04, 0.01, 0, 0, 0.01, 0], [-0.08, 0, 0.02, 0.01, 0, 0]],
     [-0.12, 0.01, 0.02, 0.01, 0.0, 0.005],
     lambda r, h, w: r.integers(0, 4, (h, w)).astype(np.int32)),
])
def test_depth_update_matches(rng, poses, obj_xi, ages):
    (jd, js, ja, jst), (td, ts, ta, tst) = _depth_update_case(rng, 60, 80, poses, obj_xi,
                                                              ages, CFG)
    stats_j = [int(getattr(jst, k)) for k in ("observed", "accepted", "rejected", "aged_out")]
    stats_t = [int(getattr(tst, k)) for k in ("observed", "accepted", "rejected", "aged_out")]
    assert stats_j[0] > 50, stats_j
    for a, b in zip(stats_t, stats_j):
        assert abs(a - b) <= max(2, 0.01 * b), (stats_t, stats_j)
    _assert_maps_close(td.numpy(), jd)
    _assert_maps_close(ts.numpy(), js)
    assert np.mean(ta.numpy() == np.asarray(ja)) >= 0.995
    assert ta.dtype == torch.int32


def test_epipolar_plain_is_what_depth_update_runs(rng):
    """depth_update = epipolar_fields + the epipolar wrapper; on the CPU
    the wrapper is the plain version, identical to calling it directly."""
    h, w = 48, 64
    jh, img, depth, K = _ring(rng, h, w, [[0, 0, 0, 0, 0, 0], [-0.05, 0, 0, 0, 0, 0]])
    g, m = _render(img, depth, K, [-0.1, 0, 0, 0, 0, 0])
    obj = frame_from_reference(jax.tree.map(np.asarray, build_frame_with_depth(
        jnp.asarray(g), jnp.asarray(m), jnp.asarray(depth), jnp.full((h, w), 0.5, jnp.float32),
        jnp.asarray(K), 1, 0, 2)), "cpu").scenes[0]
    hist = _port_history(jh)
    args = (obj, _t(np.array([-0.1, 0, 0, 0, 0, 0], np.float32)),
            _t(np.array([-0.05, 0, 0, 0, 0, 0], np.float32)), _t(depth),
            torch.full((h, w), 0.3), torch.zeros((h, w), dtype=torch.int32), hist,
            torch.full((h, w), 1.0), TCFG)
    fields, aged_out = tmapper.epipolar_fields(*args)
    assert fields.shape == (epipolar.N_FIELDS, h, w) and int(aged_out) == 0
    d, s, a, st = epipolar.epipolar_update_plain(fields, hist.gray, hist.gx, hist.gy,
                                                 hist.gmask, TCFG)
    d2, s2, a2, st2 = tmapper.depth_update(*args)
    torch.testing.assert_close(d, d2, rtol=0, atol=0)
    torch.testing.assert_close(s, s2, rtol=0, atol=0)
    assert st.tolist() == [int(st2.observed), int(st2.accepted), int(st2.rejected)]
    assert int(st2.observed) > 0
