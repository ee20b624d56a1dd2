"""The port's GN linearisation (the plain version beside the CUDA kernel),
solve and coarse-to-fine ``track`` against ``dvo_tpu.models.tracker``.

Tolerances, from the measured twin-vs-twin spread on these inputs: valid
counts equal (both evaluate the same per-pixel gates in float32); H, g and
the residual sum within 1e-4 relative to their largest entry (XLA and
PyTorch sum ~10^3 pixel terms in different orders); tracked twists within
1e-5 and per-level iteration counts equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import TrackerConfig
from dvo_tpu.models import tracker as jtracker
from dvo_tpu.models.frame import build_frame_with_depth
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.models import tracker as ttracker
from dvo_tpu_torch.models.odometry import frame_from_reference

from test_image_ops import smooth_image
from test_mapper import sharp_image

torch.set_num_threads(1)


def _frames(rng, h, w, levels, xi_true, holes=0.0):
    """Reference frame with measured depth and an object frame rendered
    from it under ``xi_true`` (dvo_tpu's own warp), both with ``levels``
    pyramid levels; optional invalid-pixel holes in the reference mask."""
    from dvo_tpu.ops.warp import warp_image

    img = sharp_image(rng, h, w)
    depth = (1.4 + 0.4 * smooth_image(rng, h, w)).astype(np.float32)
    sigma = (0.05 + 0.3 * smooth_image(rng, h, w)).astype(np.float32)
    mask = rng.random((h, w)) >= holes
    K = np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]], np.float32)
    obj_img, obj_mask = warp_image(jnp.asarray(xi_true, jnp.float32), jnp.asarray(img),
                                   jnp.ones((h, w), bool), jnp.asarray(depth), jnp.asarray(K))
    mk = lambda im, m, fid: build_frame_with_depth(
        jnp.asarray(im), jnp.asarray(m), jnp.asarray(depth), jnp.asarray(sigma),
        jnp.asarray(K), levels=levels, culls=0, frame_id=fid)
    return mk(obj_img, obj_mask, 1), mk(img, mask, 0)


def _port(frame):
    return frame_from_reference(jax.tree.map(np.asarray, frame), "cpu")


def _scene_args(obj, ref):
    return (obj.gray, obj.mask, ref.depth, ref.sigma, ref.gray, ref.mask,
            ref.gx, ref.gy, ref.gmask, ref.K)


def _assert_terms_close(t, j):
    tH, tg, tr, tc = (x.numpy() for x in t)
    jH, jg, jr, jc = (np.asarray(x) for x in j)
    assert int(tc) == int(jc)
    for a, b in ((tH, jH), (tg, jg), (tr, jr)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-12))


XI = np.array([0.004, -0.002, 0.003, 0.002, -0.001, 0.0015], np.float32)
# Linearisation point away from the rendering twist, so residuals are O(1e-2).
XI_EVAL = np.array([0.001, 0.001, 0.0, 0.0005, 0.0, 0.0], np.float32)


@pytest.mark.parametrize("level_index,cfg", [
    (0, TrackerConfig()),                            # coarsest step, no crop
    (1, TrackerConfig()),                            # step 1.5
    (2, TrackerConfig()),                            # crop level: x in [20,140], y in [20,100]
    (2, TrackerConfig(compat_weight_b_only=True)),   # faithful weight on g only
])
def test_gn_terms_plain_matches(rng, level_index, cfg):
    obj, ref = _frames(rng, 60, 80, 1, XI, holes=0.05)
    jo, jr = obj.scenes[0], ref.scenes[0]
    to, tr = _port(obj).scenes[0], _port(ref).scenes[0]
    j = jtracker.gn_terms(*_scene_args(jo, jr), jnp.asarray(XI_EVAL), level_index, cfg)
    t = ttracker.gn_terms(*_scene_args(to, tr), torch.tensor(XI_EVAL), level_index,
                          config_from_reference(cfg))
    _assert_terms_close(t, j)


def test_gn_terms_plain_at_mask_borders(rng):
    """Half the reference pixels invalid: the cyclic corner fill and the
    float gmask test decide most samples."""
    obj, ref = _frames(rng, 48, 64, 1, XI, holes=0.5)
    j = jtracker.gn_terms(*_scene_args(obj.scenes[0], ref.scenes[0]), jnp.asarray(XI_EVAL), 0,
                          TrackerConfig())
    t = ttracker.gn_terms(*_scene_args(_port(obj).scenes[0], _port(ref).scenes[0]),
                          torch.tensor(XI_EVAL), 0, config_from_reference(TrackerConfig()))
    _assert_terms_close(t, j)


def test_gn_solve_matches(rng):
    A = rng.standard_normal((6, 6)).astype(np.float32)
    H = (A @ A.T + np.eye(6, dtype=np.float32)).astype(np.float32)
    g = rng.standard_normal(6).astype(np.float32)
    for count in (0, 10):
        j = np.asarray(jtracker.gn_solve(jnp.asarray(H), jnp.asarray(g), jnp.asarray(count), 1e-6))
        t = ttracker.gn_solve(torch.tensor(H), torch.tensor(g), torch.tensor(count), 1e-6).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)


def test_gn_solve_non_pd_gives_nan():
    """A failed factorisation must not become an update: NaN, which the
    iteration's finiteness guard rejects (JAX's Cholesky gives NaN too)."""
    H = -np.eye(6, dtype=np.float32)
    t = ttracker.gn_solve(torch.tensor(H), torch.ones(6), torch.tensor(5), 1e-6)
    assert torch.isnan(t).all()


@pytest.mark.parametrize("xi_true,cfg", [
    ([0.01, -0.004, 0.006, 0.002, -0.002, 0.003], TrackerConfig()),
    ([0.0, 0.0, 0.0, 0.0, 0.0, 0.0], TrackerConfig()),
    ([0.008, 0.002, -0.004, 0.0, 0.003, 0.0], TrackerConfig(min_residual=0.0, max_iterations=6)),
])
def test_track_matches(rng, xi_true, cfg):
    """Coarse-to-fine over 2 levels: the port's fixed-length masked driver
    against dvo_tpu's default early-exit driver — same twist, same active
    iterations, same per-iteration statistics."""
    obj, ref = _frames(rng, 60, 80, 2, np.asarray(xi_true, np.float32))
    j = jtracker.track(obj, ref, cfg)
    t = ttracker.track(_port(obj), _port(ref), config_from_reference(cfg))
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    np.testing.assert_allclose(t.xi.numpy(), np.asarray(j.xi), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.valid_counts.numpy(), np.asarray(j.valid_counts))
    np.testing.assert_allclose(t.residuals.numpy(), np.asarray(j.residuals), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(t.update_norms.numpy(), np.asarray(j.update_norms),
                               rtol=1e-3, atol=1e-7)


def test_track_with_warm_start_matches(rng):
    obj, ref = _frames(rng, 48, 64, 2, np.array([0.006, 0, 0.003, 0, 0.001, 0], np.float32))
    xi0 = np.array([0.005, 0, 0.002, 0, 0.001, 0], np.float32)
    cfg = TrackerConfig()
    j = jtracker.track(obj, ref, cfg, xi0=jnp.asarray(xi0))
    t = ttracker.track(_port(obj), _port(ref), config_from_reference(cfg),
                       xi0=torch.tensor(xi0))
    np.testing.assert_array_equal(t.iterations.numpy(), np.asarray(j.iterations))
    np.testing.assert_allclose(t.xi.numpy(), np.asarray(j.xi), rtol=0, atol=1e-5)


def test_track_result_shapes(rng):
    obj, ref = _frames(rng, 24, 32, 2, XI)
    cfg = dataclasses.replace(TrackerConfig(), max_iterations=4)
    t = ttracker.track(_port(obj), _port(ref), config_from_reference(cfg))
    assert t.residuals.shape == (2, 4) and t.valid_counts.dtype == torch.int32
    assert t.iterations.shape == (2,) and int(t.iterations.max()) <= 4
