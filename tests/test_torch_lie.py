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


def test_inverse_and_invert_T_match(rng):
    xi = _twists(rng, 8, 0.4)
    np.testing.assert_array_equal(*_both("inverse", xi))
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    j, t = _both("invert_T", T)
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(t @ T, np.broadcast_to(np.eye(4), T.shape), atol=1e-6)


# ------------------------------------------------ the chain's derivatives
#
# The pose graph differentiates log(exp(z)^-1 (exp(xi_i) exp(d_i))^-1
# (exp(xi_j) exp(d_j))) at d = 0.  ``dvo_tpu`` takes ``jax.jacfwd``; the port
# one forward-mode pass (``posegraph._edge_terms``).  Both run the same
# float32 formulas, so the Jacobians are held at 1e-5 (2e-6 measured), and
# must be finite at the edges where a branch of a ``where`` is singular.

def _edge_cases(rng):
    """(xi_i, xi_j, z) rows: generic twists; an exactly consistent edge
    (xi_j == xi_i, z == 0); a pure translation; a relative rotation below
    the 1e-6 rad threshold; one just above it."""
    xi_i, xi_j, z = (_twists(rng, 9, 0.3) for _ in range(3))
    xi_j[4] = xi_i[4]
    z[4] = 0.0
    xi_i[5], xi_j[5], z[5] = 0.0, [0.2, -0.1, 0.05, 0, 0, 0], [0.1, 0, 0, 0, 0, 0]
    xi_j[6] = xi_i[6]
    z[6] = [0.01, 0, 0, 3e-7, 0, -2e-7]
    xi_j[7] = xi_i[7]
    z[7] = [0, 0.01, 0, 2e-6, -1e-6, 1e-6]
    xi_i[8], xi_j[8], z[8] = 0.0, 0.0, 0.0          # identity everywhere
    return xi_i, xi_j, z


def _edge_terms_both(rng):
    from dvo_tpu.models import posegraph as jpg
    from dvo_tpu_torch.models import posegraph as tpg

    xi_i, xi_j, z = _edge_cases(rng)
    n = len(z)
    xi = np.concatenate([xi_i, xi_j])
    i, j = np.arange(n), np.arange(n) + n
    want = jpg._edge_terms(jnp.asarray(xi), jpg.PoseGraphEdges(
        jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32), jnp.asarray(z),
        jnp.ones(n, jnp.float32)))
    got = tpg._edge_terms(torch.tensor(xi), tpg.edges_from_arrays(i, j, z, np.ones(n), "cpu"))
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("index,name", enumerate(["r", "Ji", "Jj"]))
def test_edge_residual_jacobians_match_jacfwd(rng, index, name):
    want, got = _edge_terms_both(rng)
    assert got[index].shape == want[index].shape
    assert np.all(np.isfinite(got[index])) and np.all(np.isfinite(want[index]))
    np.testing.assert_allclose(got[index], want[index], rtol=0, atol=1e-5)
    if name == "Jj":
        # At an exactly consistent edge the residual moves one for one with
        # d_j: the rotation block is the identity, not the zero that a
        # constant small-angle branch would give.
        np.testing.assert_allclose(np.diagonal(got[index][4]), 1.0, atol=1e-5)
        np.testing.assert_allclose(np.diagonal(got[index][8]), 1.0, atol=1e-6)


def test_chain_differentiates_in_reverse_mode_too(rng):
    """``torch.autograd.grad`` through the same chain (batched one-hot
    ``grad_outputs``) gives the forward-mode Jacobian: no untaken branch
    leaks a NaN or an infinite derivative into either mode."""
    from dvo_tpu_torch.models import posegraph as tpg

    xi_i, xi_j, z = (torch.tensor(a) for a in _edge_cases(rng))
    n = len(z)
    _, Ji, Jj = tpg._edge_terms(torch.cat([xi_i, xi_j]), tpg.PoseGraphEdges(
        torch.arange(n), torch.arange(n) + n, z, torch.ones(n)))
    d_i = torch.zeros((n, 6), requires_grad=True)
    d_j = torch.zeros((n, 6), requires_grad=True)
    r = tpg._edge_residual(xi_i, xi_j, z, d_i, d_j)
    for a in range(6):
        gi, gj = torch.autograd.grad(r, (d_i, d_j), torch.eye(6)[a].expand(n, 6),
                                     retain_graph=True)
        assert torch.isfinite(gi).all() and torch.isfinite(gj).all()
        torch.testing.assert_close(gi, Ji[:, a], rtol=0, atol=1e-5)
        torch.testing.assert_close(gj, Jj[:, a], rtol=0, atol=1e-5)
