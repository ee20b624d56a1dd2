"""``dvo_tpu_torch.ops`` against ``dvo_tpu.ops`` on the same inputs: image
decimation and gradients, both bilinear samplers (mask borders and
out-of-range corners included), the warp geometry, the Kinect
registration and the depth filter.

Tolerances: decimation, gradients, masks and validity flags are exact.
Sampled and warped values agree to 1e-5 (float32 on both sides; the only
difference is the order in which XLA and PyTorch sum 3x3 products)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import DepthFilterConfig
from dvo_tpu.ops import depth_filter as jdf
from dvo_tpu.ops import image as jimage
from dvo_tpu.ops import sampling as jsampling
from dvo_tpu.ops import warp as jwarp
from dvo_tpu_torch.ops import depth_filter as tdf
from dvo_tpu_torch.config import config_from_reference
from dvo_tpu_torch.ops import image as timage
from dvo_tpu_torch.ops import sampling as tsampling
from dvo_tpu_torch.ops import warp as twarp

from test_image_ops import smooth_image

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("times", [0, 1, 2])
def test_cull_image_and_intrinsic(rng, times):
    img = smooth_image(rng, 32, 48)
    np.testing.assert_array_equal(timage.cull_image(_t(img), times).numpy(),
                                  np.asarray(jimage.cull_image(jnp.asarray(img), times)))
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(timage.cull_intrinsic(_t(K), times).numpy(),
                                  np.asarray(jimage.cull_intrinsic(jnp.asarray(K), times)))


@pytest.mark.parametrize("times", [1, 2])
def test_cull_mask(rng, times):
    mask = rng.random((32, 48)) > 0.3
    np.testing.assert_array_equal(timage.cull_mask(_t(mask), times).numpy(),
                                  np.asarray(jimage.cull_mask(jnp.asarray(mask), times)))


def test_gradients_with_mask_holes(rng):
    img = smooth_image(rng, 20, 24)
    mask = rng.random((20, 24)) > 0.2
    j = jimage.gradients(jnp.asarray(img), jnp.asarray(mask))
    t = timage.gradients(_t(img), _t(mask))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _points(rng, h, w, n=400):
    """Points over and beyond the image: negative, past the last row and
    column (where +1 corners fall back), and on exact integer borders."""
    x = rng.uniform(-2.0, w + 1.0, n).astype(np.float32)
    y = rng.uniform(-2.0, h + 1.0, n).astype(np.float32)
    x[:8] = [0.0, w - 1.0, w - 0.5, -0.0, 3.0, w - 1.0, 0.5, w]
    y[:8] = [0.0, h - 1.0, h - 0.25, 2.0, h - 1.0, 0.0, h - 0.5, 1.0]
    return x, y


def test_bilinear_dense_matches(rng):
    h, w = 18, 22
    img = smooth_image(rng, h, w)
    x, y = _points(rng, h, w)
    jv, jok = jsampling.bilinear_dense(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    tv, tok = tsampling.bilinear_dense(_t(img), _t(x), _t(y))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("hole_share", [0.0, 0.3, 0.9])
def test_bilinear_masked_matches(rng, hole_share):
    """Cyclic-predecessor fill at mask borders, all-invalid corners, and
    out-of-range corners."""
    h, w = 18, 22
    img = smooth_image(rng, h, w)
    mask = rng.random((h, w)) >= hole_share
    x, y = _points(rng, h, w)
    jv, jok = jsampling.bilinear_masked(jnp.asarray(img), jnp.asarray(mask),
                                        jnp.asarray(x), jnp.asarray(y))
    tv, tok = tsampling.bilinear_masked(_t(img), _t(mask), _t(x), _t(y))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_warp_geometry_matches(rng):
    h, w = 16, 20
    K = np.array([[25.0, 0, w / 2], [0, 24.0, h / 2], [0, 0, 1]], np.float32)
    depth = (1.0 + smooth_image(rng, h, w)).astype(np.float32)
    depth[0, :3] = [0.0, -0.5, 1e-8]  # behind / at the camera
    xs, ys = twarp.pixel_grid(h, w)
    jxs, jys = jwarp.pixel_grid(h, w)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    xy = np.stack([np.asarray(jxs), np.asarray(jys)], axis=-1)
    T = np.asarray(jwarp.lie.se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.01, 0.03], jnp.float32)))

    jp = jwarp.back_project(jnp.asarray(K), jnp.asarray(xy), jnp.asarray(depth))
    tp = twarp.back_project(_t(K), _t(xy), _t(depth))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    (juv, jf), (tuv, tf) = (jwarp.project(jnp.asarray(K), jp), twarp.project(_t(K), tp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-5, atol=1e-4)
    (juv, jf) = jwarp.warp_points(jnp.asarray(T), jnp.asarray(xy), jnp.asarray(depth), jnp.asarray(K))
    (tuv, tf) = twarp.warp_points(_t(T), _t(xy), _t(depth), _t(K))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("xi", [[0.01, 0.0, 0.0, 0.0, 0.0, 0.0],
                                [0.02, -0.01, 0.03, 0.01, -0.02, 0.005]])
def test_warp_image_matches(rng, xi):
    h, w = 24, 32
    img = smooth_image(rng, h, w)
    mask = rng.random((h, w)) > 0.1
    depth = (1.2 + 0.5 * smooth_image(rng, h, w)).astype(np.float32)
    K = np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]], np.float32)
    xi = np.asarray(xi, np.float32)
    jv, jm = jwarp.warp_image(*(jnp.asarray(a) for a in (xi, img, mask, depth, K)))
    tv, tm = twarp.warp_image(*(_t(a) for a in (xi, img, mask, depth, K)))
    # A pixel whose warped coordinate lands within float noise of an
    # integer may round to the other side: allow 0.2% of pixels.
    assert np.mean(tm.numpy() != np.asarray(jm)) <= 0.002
    same = tm.numpy() == np.asarray(jm)
    np.testing.assert_allclose(tv.numpy()[same], np.asarray(jv)[same], rtol=1e-4, atol=1e-4)


def _kinect_pair(rng, n=None, h=12, w=16):
    """Depth (with holes) at the depth camera's size, color gray at twice
    it with a border mask, and the two intrinsics."""
    lead = () if n is None else (n,)
    depth = rng.uniform(0.5, 3.0, lead + (h, w)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = 0.0
    gray = rng.random(lead + (2 * h, 2 * w), np.float32)
    gmask = rng.random((2 * h, 2 * w)) > 0.1
    K_d = np.array([[14.0, 0, w / 2], [0, 14.0, h / 2], [0, 0, 1]], np.float32)
    K_c = np.array([[28.0, 0, w], [0, 28.0, h], [0, 0, 1]], np.float32)
    return depth, gray, gmask, K_c, K_d


@pytest.mark.parametrize("xi", [[0.0] * 6, [-0.052, 0.003, 0.001, 0.01, -0.02, 0.005]],
                         ids=["identity", "baseline"])
@pytest.mark.parametrize("sigmas", [(0.1, 1.0), (0.05, 2.0)])
def test_map_depth_to_gray_matches(rng, xi, sigmas):
    """Kinect registration: values within 1e-5, masks and sigmas equal."""
    from dvo_tpu import lie as jlie

    depth, gray, gmask, K_c, K_d = _kinect_pair(rng)
    inv_T = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    args = (depth, gray, gmask, K_c, K_d, inv_T)
    jv, jm, js = jwarp.map_depth_to_gray(*(jnp.asarray(a) for a in args), *sigmas)
    tv, tm, ts = twarp.map_depth_to_gray(*(_t(a) for a in args), *sigmas)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    assert 0 < tm.numpy().mean() < 1 and ts.dtype == torch.float32


def test_map_depth_to_gray_batches_like_frames(rng):
    """A chunk registered in one batched call equals its frames registered
    one by one, bit for bit (one (H, W) color mask for all)."""
    depth, gray, gmask, K_c, K_d = _kinect_pair(rng, n=3)
    inv_T = np.eye(4, dtype=np.float32)
    inv_T[0, 3] = -0.05
    consts = (_t(gmask), _t(K_c), _t(K_d), _t(inv_T))
    batched = twarp.map_depth_to_gray(_t(depth), _t(gray), *consts)
    for i in range(3):
        single = twarp.map_depth_to_gray(_t(depth[i]), _t(gray[i]), *consts)
        for a, b in zip(batched, single):
            torch.testing.assert_close(a[i], b, rtol=0, atol=0)


def test_depth_filter_matches(rng):
    n = 500
    mu = rng.uniform(0.3, 4.0, n).astype(np.float32)
    sg = rng.uniform(0.01, 0.6, n).astype(np.float32)
    d = (mu + rng.normal(0, 0.5, n)).astype(np.float32)
    s = rng.uniform(0.01, 0.6, n).astype(np.float32)
    obs = rng.random(n) > 0.2
    cfg = DepthFilterConfig()
    jf = jdf.gaussian_fuse(*(jnp.asarray(a) for a in (mu, sg, d, s)), obs_valid=jnp.asarray(obs))
    tf = tdf.gaussian_fuse(*(_t(a) for a in (mu, sg, d, s)), obs_valid=_t(obs))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)

    import jax

    key = jax.random.PRNGKey(5)
    reset = np.asarray(jnp.minimum(jax.random.uniform(key, (n,), minval=0.5, maxval=2.0), 4.0))
    ju = jdf.gaussian_update_with_reset(key, *(jnp.asarray(a) for a in (mu, sg, d, s)),
                                        obs_valid=jnp.asarray(obs), cfg=cfg)
    tu = tdf.gaussian_update_with_reset(*(_t(a) for a in (mu, sg, d, s)), _t(reset),
                                        obs_valid=_t(obs), cfg=config_from_reference(cfg))
    for a, b in zip(tu, ju):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_draw_reset_depth_range():
    g = torch.Generator().manual_seed(0)
    r = tdf.draw_reset_depth((64, 64), config_from_reference(DepthFilterConfig()), g)
    assert r.shape == (64, 64) and r.dtype == torch.float32
    assert float(r.min()) >= 0.5 and float(r.max()) <= 2.0
