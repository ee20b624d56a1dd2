"""``dvo_tpu_torch.models.posegraph`` against ``dvo_tpu.models.posegraph`` on
the same graphs, and the port's copy of ``utils/oracle.py`` against the
original.

Tolerances.  Edge residuals and Jacobians: 1e-5 (tests/test_torch_lie.py).
One Levenberg step: the normal matrix is a dense product in the port and an
index-add in ``dvo_tpu``, so its sums differ in order; the preconditioned
Cholesky of the ill-conditioned system amplifies that, and the step's twists
are held within 1e-4 of ``dvo_tpu``'s (1e-5 measured), its costs within 1e-4
relative.  Ten steps on the drifting circle: twists within 1e-3 (2e-4
measured), costs within 1% where they are above 1e-6.  Host bookkeeping
(``chain_edges``, ``apply_refinement``) runs the same float64 NumPy: 1e-6.
The oracle copy: tolerance 0."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu import lie as jlie
from dvo_tpu.models import posegraph as jpg
from dvo_tpu.utils import oracle as joracle
from dvo_tpu_torch import lie as tlie
from dvo_tpu_torch.models import posegraph as tpg
from dvo_tpu_torch.utils import oracle as toracle

from test_posegraph import _circle_poses, _odometry

torch.set_num_threads(1)


def _circle_graph(n=12, noise=0.02, seed=0):
    """The drifting circle of ``tests/test_posegraph.py`` with its three
    exact closures (weight 20): (xi_true, xi_drift, i, j, z, w)."""
    rng = np.random.default_rng(seed)
    xi_true = _circle_poses(n)
    zs, xi_drift = _odometry(xi_true, rng, noise=noise)
    T = [joracle.se3_exp(x) for x in xi_true]
    pairs = [(n - 1, 0), (n - 2, 0), (n - 1, 1)]
    zc = np.stack([joracle.se3_log(np.linalg.inv(T[a]) @ T[b]) for a, b in pairs])
    i = np.concatenate([np.arange(n - 1), [a for a, _ in pairs]]).astype(np.int32)
    j = np.concatenate([np.arange(1, n), [b for _, b in pairs]]).astype(np.int32)
    z = np.concatenate([zs, zc]).astype(np.float32)
    w = np.concatenate([np.ones(n - 1), np.full(len(pairs), 20.0)]).astype(np.float32)
    return xi_true, xi_drift, i, j, z, w


def _jedges(i, j, z, w):
    return jpg.PoseGraphEdges(jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32),
                              jnp.asarray(z), jnp.asarray(w))


def _both_steps(xi, i, j, z, w, lam, n_real=None):
    # Compiled: run op by op, jacfwd under vmap takes 20 s a step here.
    want = jax.jit(jpg.pose_graph_step, static_argnames="cfg")(
        jnp.asarray(xi), jnp.asarray(lam, jnp.float32), _jedges(i, j, z, w),
        jpg.PoseGraphConfig(), n_real=None if n_real is None else jnp.asarray(n_real))
    got = tpg.pose_graph_step(torch.tensor(xi), torch.tensor(lam),
                              tpg.edges_from_arrays(i, j, z, w, "cpu"), tpg.PoseGraphConfig(),
                              n_real=n_real)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _ate(xi_a, xi_b):
    ta = np.stack([joracle.se3_exp(x)[:3, 3] for x in xi_a])
    tb = np.stack([joracle.se3_exp(x)[:3, 3] for x in xi_b])
    return float(np.sqrt(np.mean(np.sum((ta - tb) ** 2, axis=-1))))


def test_step_accepted_matches():
    _, xi, i, j, z, w = _circle_graph()
    want, got = _both_steps(xi, i, j, z, w, 1e-4)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert np.abs(got[0] - xi).max() > 1e-3                 # the step was taken
    assert got[1] == want[1] == np.float32(0.25e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    np.testing.assert_array_equal(got[0][0], xi[0])         # gauge


def test_step_rejected_keeps_twists_and_raises_lambda():
    """A graph at its optimum up to float noise: the candidate is no
    better, so the twists stay and lambda grows fourfold (clipped at 1e3)."""
    xi_true, _, i, j, z, w = _circle_graph(noise=0.0)
    want, got = _both_steps(xi_true, i, j, z, w, 500.0)
    if want[1] == np.float32(1e3):                          # dvo_tpu rejected too
        np.testing.assert_array_equal(got[0], xi_true)
        assert got[1] == np.float32(1e3)
    # Either way the port's own rule holds: accepted <=> lambda shrank.
    moved = not np.array_equal(got[0], xi_true)
    assert got[1] == np.float32(125.0 if moved else 1e3)
    assert got[2] < 1e-8


def test_step_on_padded_graph_matches_and_leaves_padding_inert():
    _, xi, i, j, z, w = _circle_graph()
    n, e = len(xi), len(w)
    xi_p = np.concatenate([xi, np.zeros((4, 6), np.float32)])
    i_p, j_p = np.concatenate([i, np.zeros(5, np.int32)]), np.concatenate([j, np.zeros(5, np.int32)])
    z_p, w_p = np.concatenate([z, np.zeros((5, 6), np.float32)]), np.concatenate([w, np.zeros(5, np.float32)])
    want, got = _both_steps(xi_p, i_p, j_p, z_p, w_p, 1e-4, n_real=n)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[0][n:], 0.0)
    _, plain = _both_steps(xi, i, j, z, w, 1e-4)
    np.testing.assert_allclose(got[0][:n], plain[0], rtol=0, atol=1e-5)   # padded == unpadded
    np.testing.assert_allclose(got[2], plain[2], rtol=1e-6)


def test_step_on_zero_rotation_graph_needs_the_floor_and_stays_finite():
    """An axis-aligned chain with exactly zero rotation everywhere and one
    node no edge touches: that node's diagonal is zero, and only the
    absolute floor (matching the Jacobi clamp) keeps the factorisation
    finite; the step is finite, moves the constrained nodes and leaves the
    free one where it was."""
    n = 6
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = 0.1 * np.arange(n)
    xi[2, 1] = 0.03                                         # an inconsistency to repair
    i = np.array([0, 1, 2, 3, 0], np.int32)                 # node 5 has no edge
    j = np.array([1, 2, 3, 4, 4], np.int32)
    z = np.zeros((5, 6), np.float32)
    z[:4, 0] = 0.1
    z[4, 0] = 0.4
    w = np.ones(5, np.float32)
    want, got = _both_steps(xi, i, j, z, w, 1e-4)
    assert np.all(np.isfinite(got[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert abs(got[0][2, 1]) < 0.03                         # repaired
    np.testing.assert_array_equal(got[0][5], xi[5])
    assert tpg._DIAG_FLOOR == jpg._DIAG_FLOOR == 1e-8


def test_non_finite_solve_is_zeroed_on_the_device():
    """NaN twists make the factorisation fail: the step comes back as the
    input (a zero update, rejected), without raising."""
    _, xi, i, j, z, w = _circle_graph()
    bad = xi.copy()
    bad[3] = np.nan
    new_xi, lam, _ = tpg.pose_graph_step(torch.tensor(bad), torch.tensor(1e-4),
                                         tpg.edges_from_arrays(i, j, z, w, "cpu"),
                                         tpg.PoseGraphConfig())
    assert torch.equal(torch.isnan(new_xi), torch.isnan(torch.tensor(bad)))
    assert float(lam) == pytest.approx(4e-4)


@pytest.fixture(scope="module")
def circle_solves():
    xi_true, xi, i, j, z, w = _circle_graph()
    cfg = dict(iterations=10)
    want = jpg.optimize_pose_graph_padded(xi, i, j, list(z), w, jpg.PoseGraphConfig(**cfg))
    got = tpg.optimize_pose_graph_padded(xi, i, j, list(z), w, tpg.PoseGraphConfig(**cfg),
                                         device="cpu")
    padded = tpg.optimize_pose_graph_padded(xi, i, j, list(z), w, tpg.PoseGraphConfig(**cfg),
                                            node_bucket=64, edge_bucket=512, device="cpu")
    return xi_true, xi, want, got, padded


def test_padded_solve_on_the_circle_matches(circle_solves):
    xi_true, xi, (xi_j, costs_j), (xi_t, costs_t), _ = circle_solves
    assert xi_t.shape == xi_j.shape == (12, 6) and costs_t.shape == costs_j.shape == (10,)
    assert xi_t.dtype == np.float32 and costs_t.dtype == np.float32
    np.testing.assert_allclose(xi_t, xi_j, rtol=0, atol=1e-3)
    big = costs_j > 1e-6
    np.testing.assert_allclose(costs_t[big], costs_j[big], rtol=1e-2)
    assert costs_t[-1] < costs_t[0]
    assert _ate(xi_t, xi_true) < 0.5 * _ate(xi, xi_true)    # the closures fix the drift
    np.testing.assert_allclose(xi_t[0], xi[0], atol=1e-6)   # gauge held


def test_padding_changes_nothing(circle_solves):
    """Padded to ``dvo_tpu``'s buckets (64 nodes, 512 edges) or not at all:
    the same refined twists and costs, to the solve's own tolerance (one
    step agrees within 1e-5, test_step_on_padded_graph...; over ten steps the
    products' different lengths reorder their sums, and the last steps, on
    the cost's plateau, are accepted or rejected on float noise: 2.2e-4
    measured)."""
    _, _, _, (xi_t, costs_t), (xi_p, costs_p) = circle_solves
    np.testing.assert_allclose(xi_p, xi_t, rtol=0, atol=1e-3)
    np.testing.assert_allclose(costs_p, costs_t, rtol=1e-3, atol=1e-7)


def test_solve_repeats_bit_for_bit():
    """The normal matrix is one product of the dense Jacobian, no index-add:
    the same inputs give the same bits."""
    _, xi, i, j, z, w = _circle_graph(seed=3)
    a = tpg.optimize_pose_graph_padded(xi, i, j, list(z), w, device="cpu")
    b = tpg.optimize_pose_graph_padded(xi, i, j, list(z), w, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_consistent_graph_is_a_noop_and_empty_edges_solve():
    xi = _circle_poses(8)
    i, j, z, w = tpg.chain_edges(xi)
    for a, b in zip((i, j, z, w), jpg.chain_edges(xi)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    out, costs = tpg.optimize_pose_graph_padded(xi, i, j, list(z), w,
                                                tpg.PoseGraphConfig(iterations=3), device="cpu")
    assert costs[0] < 1e-8
    np.testing.assert_allclose(out, xi, atol=1e-4)
    out, costs = tpg.optimize_pose_graph_padded(xi[:2], [], [], [], [], device="cpu")
    np.testing.assert_array_equal(out, xi[:2])              # one weight-0 self-loop: inert
    edges = tpg.build_edges([i[:3], i[3:]], [j[:3], j[3:]], [z[:3], z[3:]], [w[:3], w[3:]],
                            device="cpu")
    assert edges.size == 7 and edges.i.dtype == torch.int64 and edges.z.dtype == torch.float32


def test_apply_refinement_matches():
    rng = np.random.default_rng(4)
    poses = np.stack([joracle.se3_exp(0.1 * f * np.array([1, 0.2, 0, 0, 0.1, 0]))
                      for f in range(7)]).astype(np.float32)
    kf_idx = [0, 2, 5]
    xi_ref = np.stack([joracle.se3_log(poses[f]) for f in kf_idx]) + 0.01 * rng.standard_normal(
        (3, 6))
    got = tpg.apply_refinement(np.arange(7.0), poses, kf_idx, xi_ref)
    want = jpg.apply_refinement(np.arange(7.0), poses, kf_idx, xi_ref)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[5], joracle.se3_exp(xi_ref[2]), atol=1e-6)
    # Frame 3 rides keyframe 1's correction: its motion since frame 2 is kept.
    np.testing.assert_allclose(np.linalg.inv(got[2]) @ got[3], np.linalg.inv(poses[2]) @ poses[3],
                               atol=1e-5)


def test_apply_live_correction_slot_semantics():
    """Slots that still hold refined keyframes (kf_id match) take their
    refined twist; slots promoted after the refinement (kf_id > max_id)
    move rigidly by the newest node's correction; the never-refined first
    keyframe and empty slots keep theirs; the reference follows the ring's
    head without aliasing it.  Held against ``dvo_tpu``'s on the same
    hand-built ring (``tests/test_posegraph.py``)."""
    from dvo_tpu.config import DVOConfig as JCfg
    from dvo_tpu.models.odometry import monocular_init as jinit
    from dvo_tpu_torch.config import config_from_reference
    from dvo_tpu_torch.models import odometry as todo

    jcfg = JCfg(pyramid=dataclasses.replace(JCfg().pyramid, levels=2, culls=0))
    gray, mask = np.zeros((16, 32), np.float32), np.ones((16, 32), bool)
    K = np.array([[30.0, 0, 16], [0, 30.0, 8], [0, 0, 1]], np.float32)
    jstate = jinit(jnp.asarray(gray), jnp.asarray(mask), jnp.asarray(K), jax.random.PRNGKey(0),
                   jcfg)
    cap = jcfg.mapper.history_capacity
    ids = np.full(cap, -1, np.int32)
    xi = np.zeros((cap, 6), np.float32)
    for slot, fid in ((0, 0), (1, 3), (2, 7), (3, 11), (4, 15)):
        ids[slot] = fid
        xi[slot, 0] = 0.01 * fid
    jstate = dataclasses.replace(jstate, history=dataclasses.replace(
        jstate.history, kf_id=jnp.asarray(ids), xi=jnp.asarray(xi),
        head=jnp.asarray(4, jnp.int32), count=jnp.asarray(5, jnp.int32)))
    tstate = todo.state_from_reference(jax.tree.map(np.asarray, jstate), "cpu")
    assert config_from_reference(jcfg).mapper.history_capacity == cap

    xi_ref_slot = np.zeros((cap, 6), np.float32)
    id_slot = np.full(cap, -2, np.int32)
    for slot, fid in ((1, 3), (2, 7), (3, 11)):
        xi_ref_slot[slot] = [0.01 * fid + 0.005, 0.002, 0, 0, 0, 0]
        id_slot[slot] = fid
    xi_ref_slot[4] = [9.9, 9.9, 9.9, 0, 0, 0]       # held id 13 then; now id 15: no match
    id_slot[4] = 13
    corr = np.eye(4, dtype=np.float32)
    corr[0, 3] = 0.005

    jout = jpg.apply_live_correction(jstate, jnp.asarray(xi_ref_slot), jnp.asarray(id_slot),
                                     jnp.asarray(11, jnp.int32), jnp.asarray(corr))
    tout = tpg.apply_live_correction(tstate, xi_ref_slot, id_slot, 11, corr)
    new_xi = tout.history.xi.numpy()
    np.testing.assert_allclose(new_xi, np.asarray(jout.history.xi), rtol=0, atol=1e-6)
    for slot in (1, 2, 3):
        np.testing.assert_array_equal(new_xi[slot], xi_ref_slot[slot])
    np.testing.assert_array_equal(new_xi[0], xi[0])
    np.testing.assert_array_equal(new_xi[5:], xi[5:])
    np.testing.assert_array_equal(tout.ref.xi.numpy(), new_xi[4])
    assert tout.ref.xi.data_ptr() != tout.history.xi[4].data_ptr()
    assert torch.equal(tstate.history.xi, torch.tensor(xi))        # the old state is intact


def _oracle_cases():
    rng = np.random.default_rng(7)
    xi = rng.standard_normal(6) * 0.3
    img = rng.random((9, 11))
    K = np.array([[12.0, 0, 5.5], [0, 12.0, 4.5], [0, 0, 1]])
    depth = 1.0 + rng.random((9, 11))
    return {
        "hat": (xi[3:],), "so3_exp": (xi[3:],), "so3_log": (joracle.so3_exp(xi[3:]),),
        "se3_exp": (xi,), "se3_log": (joracle.se3_exp(xi),), "compose": (xi, xi[::-1].copy()),
        "cull_image": (img, 1), "cull_intrinsic": (K, 2), "gradiate": (img, True),
        "get_subpixel_from_dense": (img, 3.3, 4.6), "project": (K, np.array([0.1, -0.2, 1.5])),
        "back_project": (K, 3.0, 4.0, 1.5), "warp_point": (xi * 0.1, 3.0, 4.0, 1.5, K),
        "warp_image": (xi * 0.05, img, depth, K),
        "gaussian_gate": (1.0, 0.2, 1.1, 0.3), "gaussian_fuse": (1.0, 0.2, 1.1, 0.3),
        "regularize": (depth, 0.1 + 0.2 * rng.random((9, 11))),
    }


@pytest.mark.parametrize("name", sorted(_oracle_cases()))
def test_oracle_copy_equals_the_original(name):
    args = _oracle_cases()[name]
    want, got = getattr(joracle, name)(*args), getattr(toracle, name)(*args)
    for a, b in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_oracle_copy_defines_what_the_original_defines():
    names = lambda mod: {n for n, v in vars(mod).items()
                         if inspect.isfunction(v) and v.__module__ == mod.__name__}
    assert names(toracle) == names(joracle)
    for n in names(joracle):
        assert inspect.signature(getattr(toracle, n)) == inspect.signature(getattr(joracle, n))
    assert (toracle.INVALID, toracle.EPSILON) == (joracle.INVALID, joracle.EPSILON)


def test_lie_round_trip_between_device_math_and_the_host_oracle(rng):
    """The harvester moves poses between float32 device twists and the
    float64 host oracle; the two agree to float32 noise."""
    xi = (rng.standard_normal((5, 6)) * 0.3).astype(np.float32)
    T = tlie.se3_exp(torch.tensor(xi)).numpy()
    for k in range(5):
        np.testing.assert_allclose(toracle.se3_exp(xi[k]), T[k], atol=1e-6)
        np.testing.assert_allclose(toracle.se3_log(T[k]), xi[k], atol=1e-5)
    np.testing.assert_allclose(np.asarray(jlie.se3_exp(jnp.asarray(xi))), T, atol=1e-6)
