"""The port's frame build (``dvo_tpu_torch.ops.cuda.framebuild`` and
``models.frame``) against ``dvo_tpu``'s, with exact equality: every plane
is a copy or one float32 subtraction, so the plain version must equal both
the Pallas kernel (interpret mode) and the XLA build bit for bit.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it equal to
the plain version there).  Here its wrapper is driven through a NumPy
transcription of the kernel's per-thread index arithmetic, which checks the
wrapper's one-buffer-per-plane-kind layout and its per-level views."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.models import frame as jframe
from dvo_tpu.ops.pallas import framebuild as jfb
from dvo_tpu_torch.models import frame as tframe
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.models.odometry import frame_from_reference
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.cuda import framebuild as tfb

torch.set_num_threads(1)

SHAPES = [(120, 160, 3), (212, 256, 4), (53, 61, 2)]
KEYS = ("gray", "depth", "sigma", "mask", "gx", "gy", "gmask")


def _inputs(seed, h, w):
    rng = np.random.default_rng(seed)
    gray = rng.random((h, w), np.float32)
    mask = rng.random((h, w)) >= 0.07
    depth = (rng.random((h, w), np.float32) * 3 + 0.3).astype(np.float32)
    sigma = (rng.random((h, w), np.float32) * 0.4 + 0.05).astype(np.float32)
    return gray, mask, depth, sigma


def _equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("h,w,levels", SHAPES)
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_build_pyramid_planes_matches_dvo_tpu(h, w, levels, reference):
    gray, mask, depth, sigma = _inputs(h * w, h, w)
    got = tfb.build_pyramid_planes_plain(*(torch.from_numpy(x) for x in (gray, mask, depth, sigma)),
                                         levels)
    args = [jnp.asarray(x) for x in (gray, mask, depth, sigma)]
    if reference == "pallas_interpret":
        want = jfb.build_pyramid_planes(*args, levels, interpret=True)
    else:
        want = [{k: getattr(s, k) for k in KEYS}
                for s in jframe._pyramid(*args, jnp.eye(3), levels)]
    assert len(got) == len(want) == levels
    for i, (g, wnt) in enumerate(zip(got, want)):
        assert tuple(g) == KEYS
        for k in KEYS:
            _equal(g[k], wnt[k], f"level {i} {k}")


@pytest.mark.parametrize("entry", ["pair", "one"])
@pytest.mark.parametrize("h,w,levels", SHAPES)
def test_cull_pyramids_match_pallas_interpret(h, w, levels, entry):
    _, _, depth, sigma = _inputs(h + w, h, w)
    if entry == "pair":
        got = tfb.cull_pyramid_pair_plain(torch.from_numpy(depth), torch.from_numpy(sigma), levels)
        want = jfb.cull_pyramid_pair(jnp.asarray(depth), jnp.asarray(sigma), levels,
                                     interpret=True)
        got = [x for pair in got for x in pair]
        want = [x for pair in want for x in pair]
    else:
        got = tfb.cull_pyramid_one_plain(torch.from_numpy(depth), levels)
        want = jfb.cull_pyramid_one(jnp.asarray(depth), levels, interpret=True)
    assert len(got) == len(want)
    for i, (g, wnt) in enumerate(zip(got, want)):
        _equal(g, wnt, f"plane {i}")


@pytest.mark.parametrize("h,w,levels", [(5, 3, 3), (2, 2, 2), (1, 7, 2), (9, 1, 4)])
def test_tiny_levels_have_no_interior(h, w, levels):
    """Levels one or two pixels wide have no interior pixel: zero
    gradients, gmask all False — as dvo_tpu's XLA build."""
    gray, mask, depth, sigma = _inputs(7, h, w)
    mask[:] = True
    got = tfb.build_pyramid_planes_plain(*(torch.from_numpy(x) for x in (gray, mask, depth, sigma)),
                                         levels)
    want = jframe._pyramid(*(jnp.asarray(x) for x in (gray, mask, depth, sigma)), jnp.eye(3),
                           levels)
    for g, s in zip(got, want):
        for k in KEYS:
            _equal(g[k], getattr(s, k), k)
        ht, wt = g["gray"].shape
        assert wt > 2 or not g["gx"].any()
        assert ht > 2 or not g["gy"].any()
        assert min(ht, wt) > 2 or not g["gmask"].any()


@pytest.mark.parametrize("gray_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("culls", [0, 1])
def test_build_frame_with_depth_matches_dvo_tpu(gray_dtype, culls):
    h, w, levels = 106, 128, 4
    gray, mask, depth, sigma = _inputs(11, h, w)
    if gray_dtype == "uint8":
        gray = np.round(gray * 255).astype(np.uint8)
    K = np.array([[150.0, 0, 64.0], [0, 150.0, 53.0], [0, 0, 1]], np.float32)
    want = jframe.build_frame_with_depth(*(jnp.asarray(x) for x in (gray, mask, depth, sigma, K)),
                                         levels, culls, 5)
    got = tframe.build_frame_with_depth(*(torch.from_numpy(x) for x in (gray, mask, depth, sigma, K)),
                                        levels, culls, 5)
    assert got.levels == levels and got.frame_id == int(want.frame_id) == 5
    for i, (g, s) in enumerate(zip(got.scenes, want.scenes)):
        for f in dataclasses.fields(g):
            _equal(getattr(g, f.name), getattr(s, f.name), f"level {i} {f.name}")
    for name in ("xi", "relative_xi", "age"):
        _equal(getattr(got, name), getattr(want, name), name)


def test_with_depth_matches_dvo_tpu():
    """``with_depth`` re-culls depth and sigma (the pair build) or depth
    alone, keeping sigma (the one-plane build)."""
    h, w, levels = 120, 160, 3
    gray, mask, depth, sigma = _inputs(3, h, w)
    K = np.eye(3, dtype=np.float32)
    jf = jframe.build_frame_with_depth(*(jnp.asarray(x) for x in (gray, mask, depth, sigma, K)),
                                       levels, 0, 0)
    tf = frame_from_reference(jax.tree.map(np.asarray, jf), "cpu")
    d2, s2 = depth * 0.5, sigma + 0.25
    for args in ((d2, s2), (d2,)):
        want = jframe.with_depth(jf, *(jnp.asarray(x) for x in args))
        got = tframe.with_depth(tf, *(torch.from_numpy(x) for x in args))
        for g, s in zip(got.scenes, want.scenes):
            _equal(g.depth, s.depth, "depth")
            _equal(g.sigma, s.sigma, "sigma")


# ------------------------------------------- the wrapper's launch, emulated

class _EmulatedLibrary:
    """``dvo_framebuild`` transcribed to NumPy, thread by thread: what
    ``csrc/framebuild.cu`` computes for output pixel p."""

    def dvo_framebuild(self, v0, v1, v2, mask, vals, mask_out, gx_out, gy_out, gmask_out,
                       h0, w0, levels, n_val, total, stream):
        def arr(ptr, n, ctype):
            return np.ctypeslib.as_array((ctype * n).from_address(ptr))

        f, u8 = ctypes.c_float, ctypes.c_uint8
        ins = [arr(p, h0 * w0, f) for p in (v0, v1, v2)[:n_val]]
        vals = arr(vals, n_val * total, f)
        if mask is not None:
            m = arr(mask, h0 * w0, u8)
            mo, gmo = arr(mask_out, total, u8), arr(gmask_out, total, u8)
            gxo, gyo = arr(gx_out, total, f), arr(gy_out, total, f)
        for p in range(total):
            t, off = levels - 1, 0
            while True:
                ht, wt = (h0 + (1 << t) - 1) >> t, (w0 + (1 << t) - 1) >> t
                if p < off + ht * wt:
                    break
                off += ht * wt
                t -= 1
            y, x = divmod(p - off, wt)
            row = (y << t) * w0
            base = row + (x << t)
            for k in range(n_val):
                vals[k * total + p] = ins[k][base]
            if mask is None:
                continue
            mo[p] = m[base] != 0
            in_x, in_y = 1 <= x <= wt - 2, 1 <= y <= ht - 2
            gx = gy = np.float32(0)
            ok = in_x and in_y
            if in_x:
                r, l = row + ((x + 1) << t), row + ((x - 1) << t)
                gx = ins[0][r] - ins[0][l]
                ok = ok and m[r] != 0 and m[l] != 0
            if in_y:
                d, u = ((y + 1) << t) * w0 + (x << t), ((y - 1) << t) * w0 + (x << t)
                gy = ins[0][d] - ins[0][u]
                ok = ok and m[d] != 0 and m[u] != 0
            gxo[p], gyo[p], gmo[p] = gx, gy, ok
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """Route the wrappers to the launch path on CPU tensors, with the
    emulated kernel behind it."""
    monkeypatch.setattr(tfb, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", lambda: _EmulatedLibrary())
    monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
    _build.reset_launches()
    yield
    _build.reset_launches()


@pytest.mark.parametrize("entry", ["rgbd", "tracking", "pair", "one"])
def test_launch_layout_matches_plain(emulated, entry):
    h, w, levels = 27, 35, 3
    gray, mask, depth, sigma = (torch.from_numpy(x) for x in _inputs(5, h, w))
    if entry == "rgbd":
        got = tfb.build_pyramid_planes(gray, mask, depth, sigma, levels)
        want = tfb.build_pyramid_planes_plain(gray, mask, depth, sigma, levels)
    elif entry == "tracking":
        got = tfb.build_pyramid_planes(gray, mask, None, None, levels)
        want = tfb.build_pyramid_planes_plain(gray, mask, None, None, levels)
        assert all(g["depth"] is None and g["sigma"] is None for g in got)
    elif entry == "pair":
        got = tfb.cull_pyramid_pair(depth, sigma, levels)
        want = tfb.cull_pyramid_pair_plain(depth, sigma, levels)
    else:
        got = tfb.cull_pyramid_one(depth, levels)
        want = tfb.cull_pyramid_one_plain(depth, levels)
    assert _build.LAUNCHES["framebuild"] == 1
    flat = lambda out: [x for lvl in out for x in (lvl.values() if isinstance(lvl, dict) else
                                                  lvl if isinstance(lvl, tuple) else (lvl,))]
    for g, wnt in zip(flat(got), flat(want)):
        if wnt is None:
            continue
        assert g.is_contiguous()
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)


def test_state_exchange_reads_views_at_an_offset(emulated):
    """A frame whose planes are views into shared buffers (as the CUDA build
    leaves them) goes to numpy and back unchanged."""
    gray, mask, depth, sigma = (torch.from_numpy(x) for x in _inputs(9, 30, 40))
    f = tframe.build_frame_with_depth(gray, mask, depth, sigma, torch.eye(3), 3, 0, 2)
    assert f.scenes[-1].gray.storage_offset() > 0
    state = todo.RGBDState(ref=f, frame_count=3, vel=torch.arange(6.0))
    back = todo.rgbd_state_from_reference(todo.rgbd_state_to_numpy(state), "cpu")
    assert back.frame_count == 3 and back.ref.frame_id == 2
    torch.testing.assert_close(back.vel, state.vel, rtol=0, atol=0)
    for a, b in zip(back.ref.scenes, f.scenes):
        for fld in dataclasses.fields(a):
            torch.testing.assert_close(getattr(a, fld.name), getattr(b, fld.name), rtol=0, atol=0)
