"""The port's frame build (``dvo_tpu_torch.ops.cuda.framebuild`` and
``models.frame``) against ``dvo_tpu``'s, with exact equality: every plane
is a copy or one float32 subtraction, so the plain version must equal both
the Pallas kernel (interpret mode) and the XLA build bit for bit.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them equal to
the plain versions there).  Here the wrappers are driven through a NumPy
transcription of the kernels, thread by thread (one base pixel each,
writing every level it is a sample of), which checks the kernels' index
arithmetic and the wrappers' one-buffer-per-plane-kind layout and per-level
views.  The
regularize-and-cull launch (``regularize_cull_pyramid``,
``with_regularized_depth``) is held equal to the three steps it replaces
(``with_depth``, ``regularize``, ``with_depth``) and, at the regulariser's
1e-6, to ``dvo_tpu``'s."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.models import frame as jframe
from dvo_tpu.models import mapper as jmapper
from dvo_tpu.ops.pallas import framebuild as jfb
from dvo_tpu_torch.models import frame as tframe
from dvo_tpu_torch.models import odometry as todo
from dvo_tpu_torch.models.odometry import frame_from_reference
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.config import MapperConfig
from dvo_tpu_torch.ops.cuda import framebuild as tfb
from dvo_tpu_torch.ops.cuda import regularize as treg

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

F32 = np.float32


def _arr(ptr, n, ctype):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr))


def _levels_of(y, x, levels, h0, w0, total):
    """``top_level`` and the per-level offsets: (t, level height, width,
    offset) of every level base pixel (y, x) is a sample of, finest first."""
    off, t = total, 0
    while True:
        ht, wt = (h0 + (1 << t) - 1) >> t, (w0 + (1 << t) - 1) >> t
        off -= ht * wt
        yield t, ht, wt, off
        if t + 1 >= levels or (y | x) & ((2 << t) - 1):
            return
        t += 1


def _aten_sqrt(v):
    """float32 square root as ATen's vectorised CPU kernel takes it: the
    plain version's (it is not correctly rounded for a few inputs in a
    thousand; ``sqrtf`` on the card and ``torch.sqrt`` of a CUDA tensor are)."""
    return torch.sqrt(torch.full((16,), float(v), dtype=torch.float32))[0].numpy()


TAPS = ((-1, 0), (1, 0), (0, 1), (0, -1))   # left, right, down, up


def _regularize_pixel(d, s, y, x, gain_ramp, max_depth):
    """``dvo::regularize_pixel`` in float32 scalars: the ten loads first
    (clamped addresses, an ``in`` flag per tap), then ``fuse_taps``."""
    h, w = d.shape
    taps = [(0 <= x + dx < w and 0 <= y + dy < h,
             d[min(max(y + dy, 0), h - 1), min(max(x + dx, 0), w - 1)],
             s[min(max(y + dy, 0), h - 1), min(max(x + dx, 0), w - 1)]) for dx, dy in TAPS]
    mu, sg = d[y, x], s[y, x]
    for inside, nd, ns in taps:
        if not inside:
            continue
        diff = abs(nd - mu)
        m = min(nd, diff)
        gain = F32(0.5) + m / gain_ramp * F32(0.5) if m < gain_ramp else F32(1.0)
        if not diff <= gain * max(sg, ns):
            continue
        v1, v2 = sg * sg, ns * ns
        v = v1 + v2
        safe_v = F32(1.0) if v < F32(1e-12) else v
        mu = (v2 * mu + v1 * nd) / safe_v
        sg = _aten_sqrt(v1 * v2 / safe_v)
    return min(mu, max_depth)


class _EmulatedLibrary:
    """The two entries of ``csrc/framebuild.cu`` transcribed to NumPy, thread
    by thread: each base pixel's loads (clamped neighbour addresses), then
    level 0 and every coarser level the pixel is a sample of."""

    def dvo_framebuild(self, v0, v1, v2, mask, vals, mask_out, gx_out, gy_out, gmask_out,
                       h0, w0, levels, n_val, total, stream):
        assert 1 <= levels <= tfb.MAX_LEVELS and 1 <= n_val <= tfb.MAX_VALUES
        f, u8 = ctypes.c_float, ctypes.c_uint8
        ins = [_arr(p, h0 * w0, f).reshape(h0, w0) for p in (v0, v1, v2)[:n_val]]
        vals = _arr(vals, n_val * total, f)
        if mask is not None:
            m = _arr(mask, h0 * w0, u8).reshape(h0, w0)
            mo, gmo = _arr(mask_out, total, u8), _arr(gmask_out, total, u8)
            gxo, gyo = _arr(gx_out, total, f), _arr(gy_out, total, f)
        for y in range(h0):
            for x in range(w0):
                for t, ht, wt, off in _levels_of(y, x, levels, h0, w0, total):
                    yl, xl = y >> t, x >> t
                    p = off + yl * wt + xl
                    for k in range(n_val):
                        vals[k * total + p] = ins[k][y, x]
                    if mask is None:
                        continue
                    s = 1 << t
                    taps = ((y, min(x + s, w0 - 1)), (y, max(x - s, 0)),
                            (min(y + s, h0 - 1), x), (max(y - s, 0), x))
                    g = [ins[0][q] for q in taps]
                    mm = [m[q] != 0 for q in taps]
                    in_x, in_y = 1 <= xl <= wt - 2, 1 <= yl <= ht - 2
                    mo[p] = m[y, x] != 0
                    gxo[p] = g[0] - g[1] if in_x else F32(0)
                    gyo[p] = g[2] - g[3] if in_y else F32(0)
                    gmo[p] = in_x and in_y and all(mm)
        return 0

    def dvo_regularize_cull(self, depth, sigma, vals, h0, w0, levels, total, gain_ramp,
                            max_depth, stream):
        """``regularize_cull_kernel``, thread by thread: the base pixel's
        regularised depth and its sigma, written to every level it is a
        sample of."""
        assert 1 <= levels <= tfb.MAX_LEVELS
        f = ctypes.c_float
        d = _arr(depth, h0 * w0, f).reshape(h0, w0)
        s = _arr(sigma, h0 * w0, f).reshape(h0, w0)
        out = _arr(vals, 2 * total, f)
        for y in range(h0):
            for x in range(w0):
                r = _regularize_pixel(d, s, y, x, F32(gain_ramp), F32(max_depth))
                for t, _, wt, off in _levels_of(y, x, levels, h0, w0, total):
                    p = off + (y >> t) * wt + (x >> t)
                    out[p], out[total + p] = r, s[y, x]
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """Route the wrappers to the launch path on CPU tensors, with the
    emulated kernel behind it."""
    monkeypatch.setattr(tfb, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(tframe, "resolve_device", lambda _: "cuda")
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


@pytest.mark.parametrize("h,w,levels", [(27, 35, 3), (24, 32, 4), (5, 3, 3), (16, 16, 1)])
def test_regularize_cull_launch_matches_plain(emulated, h, w, levels):
    """The one launch writes every level of both pyramids as the plain
    version does (``regularize_plain`` then the pair's culls)."""
    _, _, depth, sigma = (torch.from_numpy(x) for x in _inputs(h * w + levels, h, w))
    got = tfb.regularize_cull_pyramid(depth, sigma, levels)
    want = tfb.regularize_cull_pyramid_plain(depth, sigma, levels)
    assert _build.LAUNCHES["regularize_cull"] == 1 and _build.LAUNCHES["framebuild"] == 0
    assert len(got) == len(want) == levels
    for (gd, gs), (wd, ws) in zip(got, want):
        assert gd.is_contiguous() and gs.is_contiguous()
        assert gd.shape == wd.shape and torch.equal(gd, wd) and torch.equal(gs, ws)
    # ... which is the three steps it replaces, one by one.
    steps = tfb.cull_pyramid_pair_plain(treg.regularize_plain(depth, sigma), sigma, levels)
    for (wd, ws), (sd, ss) in zip(want, steps):
        assert torch.equal(wd, sd) and torch.equal(ws, ss)


@pytest.mark.parametrize("h,w,levels", [(5, 3, 3), (4, 4, 3), (1, 7, 2), (9, 1, 4), (13, 37, 6),
                                         (33, 65, 5)])
def test_launches_match_plain_at_odd_shapes(emulated, h, w, levels):
    """Both entries at odd widths and heights, down to 1-pixel levels
    (4x4 x 3 ends in 1x1, 9x1 x 4 in 2x1) and the deepest pyramid the
    kernels take: every plane of every level equal to the plain version."""
    gray, mask, depth, sigma = (torch.from_numpy(x) for x in _inputs(h + w + levels, h, w))
    pairs = [(tfb.build_pyramid_planes(gray, mask, depth, sigma, levels),
              tfb.build_pyramid_planes_plain(gray, mask, depth, sigma, levels)),
             (tfb.cull_pyramid_one(depth, levels), tfb.cull_pyramid_one_plain(depth, levels)),
             (tfb.regularize_cull_pyramid(depth, sigma, levels),
              tfb.regularize_cull_pyramid_plain(depth, sigma, levels))]
    assert _build.LAUNCHES["framebuild"] == 2 and _build.LAUNCHES["regularize_cull"] == 1
    flat = lambda out: [x for lvl in out for x in (lvl.values() if isinstance(lvl, dict) else
                                                  lvl if isinstance(lvl, tuple) else (lvl,))]
    for got, want in pairs:
        assert len(got) == len(want) == levels
        for g, wnt in zip(flat(got), flat(want)):
            assert g.shape == wnt.shape and g.dtype == wnt.dtype and torch.equal(g, wnt)


def test_launch_refuses_deeper_pyramids(emulated):
    gray, mask, depth, sigma = (torch.from_numpy(x) for x in _inputs(1, 8, 8))
    with pytest.raises(ValueError, match="levels=7"):
        tfb.build_pyramid_planes(gray, mask, depth, sigma, tfb.MAX_LEVELS + 1)
    with pytest.raises(ValueError, match="levels=7"):
        tfb.regularize_cull_pyramid(depth, sigma, tfb.MAX_LEVELS + 1)


def _frame_and_maps(seed, h, w, levels):
    gray, mask, depth, sigma = _inputs(seed, h, w)
    K = np.eye(3, dtype=np.float32)
    jf = jframe.build_frame_with_depth(*(jnp.asarray(x) for x in (gray, mask, depth, sigma, K)),
                                       levels, 0, 0)
    rng = np.random.default_rng(seed + 1)
    d2 = (depth * (0.8 + 0.4 * rng.random((h, w)))).astype(np.float32)
    d2[2, 2] = 9.0                                    # past the 6 m clamp
    s2 = (sigma * 0.5 + 0.02).astype(np.float32)
    age = rng.integers(0, 4, (h, w)).astype(np.int32)
    return jf, d2, s2, age


@pytest.mark.parametrize("route", ["plain", "launch"])
def test_with_regularized_depth_matches_the_three_steps_and_dvo_tpu(route, request):
    """``with_regularized_depth`` = ``with_depth`` + ``regularize`` +
    ``with_depth`` exactly (both routes), and ``dvo_tpu``'s composition of
    the same three within the regulariser's 1e-6 (culls and sigma exact)."""
    h, w, levels = 30, 40, 3
    jf, d2, s2, age = _frame_and_maps(4, h, w, levels)
    tf = frame_from_reference(jax.tree.map(np.asarray, jf), "cpu")
    td, ts, ta = (torch.from_numpy(x) for x in (d2, s2, age))
    steps = tframe.with_depth(tf, td, ts, ta)
    steps = tframe.with_depth(steps, treg.regularize_plain(td, ts))
    if route == "launch":
        request.getfixturevalue("emulated")
    got = tframe.with_regularized_depth(tf, td, ts, ta)
    if route == "launch":
        assert _build.LAUNCHES == {**{k: 0 for k in _build.LAUNCHES}, "regularize_cull": 1}
    assert torch.equal(got.age, ta)
    jw = jframe.with_depth(jf, jnp.asarray(d2), jnp.asarray(s2), jnp.asarray(age))
    jw = jframe.with_depth(jw, jmapper.regularize(jw.scenes[-1].depth, jw.scenes[-1].sigma))
    for g, st, j in zip(got.scenes, steps.scenes, jw.scenes):
        assert torch.equal(g.depth, st.depth) and torch.equal(g.sigma, st.sigma)
        assert g.gray is st.gray and g.gx is st.gx
        np.testing.assert_allclose(g.depth.numpy(), np.asarray(j.depth), rtol=1e-6, atol=1e-6)
        _equal(g.sigma, j.sigma, "sigma")
    assert float(got.base.depth.max()) <= MapperConfig().max_depth


def test_with_base_depth_touches_the_base_level_only():
    jf, d2, s2, _ = _frame_and_maps(6, 20, 24, 3)
    tf = frame_from_reference(jax.tree.map(np.asarray, jf), "cpu")
    got = tframe.with_base_depth(tf, torch.from_numpy(d2), torch.from_numpy(s2))
    assert torch.equal(got.base.depth, torch.from_numpy(d2))
    assert torch.equal(got.base.sigma, torch.from_numpy(s2))
    assert got.base.gray is tf.base.gray and got.age is tf.age
    for a, b in zip(got.scenes[:-1], tf.scenes[:-1]):
        assert a is b


def test_regularize_cull_work():
    """Depth and sigma read once, every level of both written once."""
    nbytes, flops = tfb.work_regularize_cull((120, 160), 3)
    total = 120 * 160 + 60 * 80 + 30 * 40
    assert nbytes == 8 * (120 * 160 + total) and flops == treg.FLOPS_PER_PIXEL * 120 * 160


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
