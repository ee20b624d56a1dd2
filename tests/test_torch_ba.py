"""``dvo_tpu_torch.models.ba`` against ``dvo_tpu.models.ba`` on the same
window: the 48x64 window of 4 keyframes that ``tests/test_ba.py`` renders
(a textured plane under in-plane translation, poses perturbed by 4e-3).

Tolerances.  Per-pixel terms follow the same float32 formulas and differ by
the order of a few sums: the projected coordinate (~50 px) moves by a
float32 ulp or two (4e-6 px), and the sharp texture's gradient (up to a gray
level per pixel) turns that into 6e-6 on the residual (measured).  So
residuals, weights and Jacobians are held within 1e-4 of the term's largest
magnitude on at least 99.9% of the pixels — a pixel whose sample lies within
float noise of a validity or Huber boundary may flip its weight.
The 6x6 block sums over ~3000 pixels are held at 2e-4 relative to the
largest entry (XLA and PyTorch reduce in different orders).  The damped
solve of the ill-conditioned Schur system amplifies that a thousandfold:
the port's batched-targets evaluation and its own literal double loop agree
within 1e-5 relative on the system and still differ by 3e-5 on one step's
twists (a 4.5e-3 step) and 8e-5 after three (measured).  So the solved
quantities are held as ``tests/test_ba.py`` holds ``dvo_tpu``'s sharded BA
against its single-device one: ``ba_step``'s twists within 2e-4 (5e-5
measured), ``bundle_adjust``'s after three iterations within 1e-3 (2e-4
measured), its costs within 5e-3 relative, its depths within 2e-2 on 99% of
the pixels (5.5e-3 measured; weakly constrained pixels swing with the
poses), its counts within 0.5%."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import BAConfig as JBAConfig
from dvo_tpu.models import ba as jba
from dvo_tpu_torch.config import BAConfig
from dvo_tpu_torch.models import ba as tba

from test_ba import _make_window

torch.set_num_threads(1)
M, H, W = 4, 48, 64
JCFG = JBAConfig(iterations=3, damping=1e-3)
TCFG = BAConfig(iterations=3, damping=1e-3)


@pytest.fixture(scope="module")
def windows():
    jwin, _ = _make_window(np.random.default_rng(0), m=M, h=H, w=W, pose_noise=0.004,
                           depth_noise=0.02)
    return jwin, tba.window_from_reference(jax.tree.map(np.asarray, jwin), "cpu")


@pytest.fixture(scope="module")
def increments():
    rng = np.random.default_rng(1)
    deltas = (rng.standard_normal((M, 6)) * 1e-3).astype(np.float32)
    deltas[0] = 0.0
    drho = (rng.standard_normal((M, H, W)) * 1e-2).astype(np.float32)
    return deltas, drho


def _close_fraction(got, want, tol=1e-5):
    return np.mean(np.abs(got - want) <= tol * (1.0 + np.abs(want)))


def _close_to_scale(got, want, tol=1e-4):
    """Share of entries within ``tol`` of the largest magnitude."""
    return np.mean(np.abs(got - want) <= tol * max(np.abs(want).max(), 1.0))


def _block_close(got, want, rel):
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def pair_terms(windows, increments):
    jwin, twin = windows
    deltas, drho = increments
    jcur, jT = jba._current_window(jwin, jnp.asarray(deltas), jnp.asarray(drho))
    tcur, tT = tba._current_window(twin, torch.tensor(deltas), torch.tensor(drho))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcur.depth.numpy(), np.asarray(jcur.depth), rtol=1e-6, atol=0)
    out = {}
    for k, j in [(1, 2), (2, 0), (0, 3), (3, 3)]:
        out[k, j] = ([np.asarray(a) for a in jba._pair_terms(jcur, jT, k, j, JCFG)],
                     [a.numpy() for a in tba._pair_terms(tcur, tT, k, j, TCFG)])
    out["all"] = {k: [a.numpy() for a in tba._pair_terms(tcur, tT, k, None, TCFG)]
                  for k in range(M)}
    return out


@pytest.mark.parametrize("index,name", enumerate(["r", "w", "Jk", "Jj", "Jrho"]))
def test_pair_terms_match(pair_terms, index, name):
    for key in [(1, 2), (2, 0), (0, 3), (3, 3)]:
        want, got = pair_terms[key]
        assert got[index].shape == want[index].shape
        assert _close_to_scale(got[index], want[index]) >= 0.999, (name, key)
    assert (pair_terms[1, 2][1][1] > 0).mean() > 0.2     # the pair sees each other


@pytest.mark.parametrize("index,name", enumerate(["r", "w", "Jk", "Jj", "Jrho"]))
def test_pair_terms_of_all_targets_equal_one_by_one(pair_terms, index, name):
    """One batched evaluation of every target of a host gives, target by
    target, the bits of the single-target evaluation."""
    for (k, j) in [(1, 2), (2, 0), (0, 3), (3, 3)]:
        np.testing.assert_array_equal(pair_terms["all"][k][index][j], pair_terms[k, j][1][index])


@pytest.fixture(scope="module")
def systems(windows, increments):
    jwin, twin = windows
    deltas, drho = increments
    jcur, jT = jba._current_window(jwin, jnp.asarray(deltas), jnp.asarray(drho))
    tcur, tT = tba._current_window(twin, torch.tensor(deltas), torch.tensor(drho))
    out = dict(
        host=([np.asarray(a) for a in jba.host_system(jcur, jT, 2, JCFG)],
              [a.numpy() for a in tba.host_system(tcur, tT, 2, TCFG)],
              [a.numpy() for a in tba.host_system(tcur, tT, 2, TCFG, batch_targets=False)]),
        build=([np.asarray(a) for a in jba.build_system(jwin, jnp.asarray(deltas),
                                                         jnp.asarray(drho), JCFG)],
               [a.numpy() for a in tba.build_system(twin, torch.tensor(deltas),
                                                    torch.tensor(drho), TCFG)],
               [a.numpy() for a in tba.build_system(twin, torch.tensor(deltas),
                                                    torch.tensor(drho), TCFG,
                                                    batch_targets=False)]),
    )
    return out


@pytest.mark.parametrize("which", ["host", "build"])
@pytest.mark.parametrize("index,name", enumerate(["S", "g", "hdd", "gd", "cost", "count"]))
def test_system_matches(systems, which, index, name):
    want, got, loop = systems[which]
    assert got[index].shape == want[index].shape == loop[index].shape
    if name == "count":
        assert abs(int(got[index]) - int(want[index])) <= 0.005 * int(want[index])
        assert int(got[index]) == int(loop[index]) > 1000
    elif name in ("hdd", "gd"):
        assert _close_fraction(got[index], want[index], 1e-4) >= 0.999
        assert _close_fraction(got[index], loop[index], 1e-5) >= 0.9999
    else:
        _block_close(got[index], want[index], 2e-4)
        _block_close(got[index], loop[index], 1e-5)     # batched targets vs double loop


def test_coupling_dot_matches(windows, increments):
    jwin, twin = windows
    deltas, drho = increments
    dc = (np.random.default_rng(2).standard_normal(6 * M) * 1e-3).astype(np.float32)
    jcur, jT = jba._current_window(jwin, jnp.asarray(deltas), jnp.asarray(drho))
    tcur, tT = tba._current_window(twin, torch.tensor(deltas), torch.tensor(drho))
    want = np.asarray(jba.coupling_dot(jcur, jT, 1, jnp.asarray(dc), JCFG))
    got = tba.coupling_dot(tcur, tT, 1, torch.tensor(dc), TCFG).numpy()
    loop = tba.coupling_dot(tcur, tT, 1, torch.tensor(dc), TCFG, batch_targets=False).numpy()
    scale = np.abs(want).max()
    assert np.mean(np.abs(got - want) <= 1e-4 * scale) >= 0.999
    np.testing.assert_allclose(got, loop, rtol=0, atol=1e-5 * scale)


def test_ba_step_matches(windows, increments):
    jwin, twin = windows
    deltas, drho = increments
    want = [np.asarray(a) for a in jba.ba_step(jwin, jnp.asarray(deltas), jnp.asarray(drho), JCFG)]
    got = [a.numpy() for a in tba.ba_step(twin, torch.tensor(deltas), torch.tensor(drho), TCFG)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-4)
    assert _close_fraction(got[1], want[1], 1e-3) >= 0.99
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    assert abs(int(got[3]) - int(want[3])) <= 0.005 * int(want[3])
    np.testing.assert_array_equal(got[0][0], 0.0)       # the gauge keyframe stays put


@pytest.fixture(scope="module")
def adjusted(windows):
    jwin, twin = windows
    return (jba.bundle_adjust(jwin, JCFG), tba.bundle_adjust(twin, TCFG),
            tba.bundle_adjust(twin, TCFG, batch_targets=False))


@pytest.mark.parametrize("field", ["xi", "depth", "costs", "counts"])
def test_bundle_adjust_matches(adjusted, windows, field):
    want, got, loop = (np.asarray(getattr(r, field)) if not isinstance(getattr(r, field),
                                                                      torch.Tensor)
                       else getattr(r, field).numpy() for r in adjusted)
    assert got.shape == want.shape == loop.shape
    if field == "xi":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        np.testing.assert_allclose(got, loop, rtol=0, atol=1e-3)
        moved = np.abs(want - np.asarray(windows[0].xi)).max()
        assert moved > 1e-3                             # the solve did move the poses
    elif field == "depth":
        assert _close_fraction(got, want, 2e-2) >= 0.99
        assert _close_fraction(got, loop, 2e-2) >= 0.99
    elif field == "costs":
        np.testing.assert_allclose(got, want, rtol=5e-3)
        np.testing.assert_allclose(got, loop, rtol=5e-3)
        assert got[-1] < got[0]
    else:
        assert got.dtype == np.int32
        assert np.all(np.abs(got - want) <= 0.005 * want)
        assert np.all(np.abs(got - loop) <= 0.005 * loop)


def test_failed_factorisation_gives_nans_without_raising(windows):
    """A window whose system is not positive definite (NaN depths) must not
    raise or read the device: the step comes back non-finite, as
    ``dvo_tpu``'s ``cho_factor`` leaves it."""
    _, twin = windows
    bad = dataclasses.replace(twin, xi=torch.full_like(twin.xi, float("nan")))
    res = tba.bundle_adjust(bad, dataclasses.replace(TCFG, iterations=1))
    assert not torch.isfinite(res.xi[1:]).any()


def test_products_are_full_float32():
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _ring(package, h=16, w=24, pushes=6, cap=4):
    """A ring of ``cap`` slots after ``pushes`` keyframes with distinct
    planes, in either package."""
    rng = np.random.default_rng(5)
    K = np.array([[30.0, 0, 12], [0, 30.0, 8], [0, 0, 1]], np.float32)
    if package == "jax":
        from dvo_tpu.models.frame import build_frame_with_depth
        from dvo_tpu.models.history import KeyframeHistory, push
        conv, hist = jnp.asarray, KeyframeHistory.create(cap, h, w)
    else:
        from dvo_tpu_torch.models.frame import build_frame_with_depth
        from dvo_tpu_torch.models.history import KeyframeHistory, push
        conv, hist = torch.tensor, KeyframeHistory.create(cap, h, w)
    for i in range(pushes):
        frame = build_frame_with_depth(
            conv(rng.random((h, w), np.float32)), conv(rng.random((h, w)) > 0.1),
            conv(rng.random((h, w), np.float32) + 1.0), conv(np.full((h, w), 0.1, np.float32)),
            conv(K), 1, 0, i)
        frame = dataclasses.replace(frame, xi=conv(np.full(6, 0.01 * i, np.float32)))
        hist = push(hist, frame)
    return hist, conv(K)


@pytest.mark.parametrize("pushes,m", [(6, 3), (6, 4), (2, 3)])
def test_window_from_history_matches(pushes, m):
    """The newest ``m`` keyframes, oldest first, wrapped ring included; with
    fewer live keyframes than ``m`` the ages clamp to the oldest."""
    jhist, jK = _ring("jax", pushes=pushes)
    thist, tK = _ring("torch", pushes=pushes)
    slots = tba.window_slots(thist, m)
    assert slots == [int(s) for s in np.asarray(jba.window_slots(jhist, m))]
    jwin, twin = jba.window_from_history(jhist, jK, m), tba.window_from_history(thist, tK, m)
    for f in dataclasses.fields(tba.BAWindow):
        np.testing.assert_array_equal(getattr(twin, f.name).numpy(),
                                      np.asarray(getattr(jwin, f.name)), err_msg=f.name)


def test_refresh_head_and_write_back_match():
    """``refresh_head`` puts the reference keyframe's current maps into its
    slot and ``write_back`` lands refined twists and depths at the window's
    slots, as ``dvo_tpu``'s do; neither writes into the stacks it was
    given."""
    from dvo_tpu.models import history as jh
    from dvo_tpu_torch.models import history as th

    jhist, _ = _ring("jax")
    thist, _ = _ring("torch")
    before = thist.depth.clone()
    rng = np.random.default_rng(6)
    xi = rng.random((3, 6), np.float32)
    depth = rng.random((3, 16, 24), np.float32)
    jout = jh.write_back(jhist, jba.window_slots(jhist, 3), jnp.asarray(xi), jnp.asarray(depth))
    tout = th.write_back(thist, tba.window_slots(thist, 3), torch.tensor(xi), torch.tensor(depth))
    np.testing.assert_array_equal(tout.xi.numpy(), np.asarray(jout.xi))
    np.testing.assert_array_equal(tout.depth.numpy(), np.asarray(jout.depth))
    assert torch.equal(thist.depth, before) and tout.depth.data_ptr() != thist.depth.data_ptr()
    np.testing.assert_array_equal(tout.depth[thist.head].numpy(), depth[-1])   # newest last
    assert (tout.head, tout.count) == (thist.head, thist.count)
