"""``dvo_tpu_torch.lie`` against ``dvo_tpu.lie`` on the same float32 inputs.

Tolerance: both run float32 on the CPU with the same formulas; they differ
only in the order XLA and PyTorch sum the 3x3 products, which measured
below 1e-6 here, so values are held to 1e-5 (relative + absolute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu import lie as jlie
from dvo_tpu_torch import lie as tlie

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _twists(rng, n, scale):
    return (rng.standard_normal((n, 6)) * scale).astype(np.float32)


def _small_twists():
    """Pure translation, rotations under and around the 1e-6 rad threshold."""
    xi = np.zeros((4, 6), np.float32)
    xi[0, :3] = [0.1, -0.2, 0.3]
    xi[1] = [0.1, 0, 0, 1e-8, -1e-8, 1e-8]
    xi[2] = [0.0, 0.02, 0, 4e-7, 0, 0]
    xi[3] = [0.01, 0, -0.01, 3e-6, 2e-6, -1e-6]
    return xi


def _both(fn_name, *arrays):
    j = np.asarray(getattr(jlie, fn_name)(*(jnp.asarray(a) for a in arrays)))
    t = getattr(tlie, fn_name)(*(torch.tensor(a) for a in arrays)).numpy()
    return j, t


@pytest.mark.parametrize("scale", [0.5, 0.05])
def test_se3_exp_matches(rng, scale):
    j, t = _both("se3_exp", _twists(rng, 32, scale))
    np.testing.assert_allclose(t, j, **TOL)


def test_se3_exp_small_angle_matches():
    j, t = _both("se3_exp", _small_twists())
    assert np.all(np.isfinite(t))
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("scale", [0.5, 0.05])
def test_se3_log_matches(rng, scale):
    T = np.asarray(jlie.se3_exp(jnp.asarray(_twists(rng, 32, scale))))
    j, t = _both("se3_log", T)
    np.testing.assert_allclose(t, j, **TOL)


def test_so3_log_is_exactly_zero_below_threshold():
    """The reference's zero value below 1e-6 rad: parity of the whole
    pipeline depends on it (compose of near-identity twists)."""
    T = np.asarray(jlie.se3_exp(jnp.asarray(_small_twists())))
    j, t = _both("se3_log", T)
    np.testing.assert_array_equal(t[:2, 3:], 0.0)
    np.testing.assert_array_equal(t[:2, 3:], j[:2, 3:])
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("scale", [0.3, 0.01])
def test_compose_matches(rng, scale):
    a, b = _twists(rng, 16, scale), _twists(rng, 16, scale)
    j, t = _both("compose", a, b)
    np.testing.assert_allclose(t, j, **TOL)


def test_compose_broadcasts_one_against_many(rng):
    """The mapper composes one pose with every ring slot at once."""
    a, b = _twists(rng, 1, 0.2)[0], _twists(rng, 8, 0.2)
    t = tlie.compose(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    j = np.stack([np.asarray(jlie.compose(jnp.asarray(a), jnp.asarray(bi))) for bi in b])
    np.testing.assert_allclose(t, j, **TOL)


def test_transform_hat_and_finite(rng):
    T = np.asarray(jlie.se3_exp(jnp.asarray(_twists(rng, 1, 0.3)[0])))
    pts = rng.standard_normal((5, 7, 3)).astype(np.float32)
    j, t = _both("transform", T, pts)
    np.testing.assert_allclose(t, j, **TOL)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(*_both("hat", w))
    xi = _twists(rng, 3, 1.0)
    xi[1, 2] = np.nan
    xi[2, 5] = np.inf
    np.testing.assert_array_equal(*_both("is_finite_xi", xi))
