"""The port's depth regulariser (``dvo_tpu_torch.ops.cuda.regularize``)
against ``dvo_tpu``'s: ``regularize_plain`` against the Pallas kernel
(``regularize_pallas`` in interpret mode) and the XLA twin
(``dvo_tpu.models.mapper.regularize``), at 1e-6 (the tolerance
``tests/test_torch_mapper.py`` holds the twin to: XLA may fuse the gate's
and the fusion's operations otherwise than the op-by-op plain version).

The CUDA kernel runs only on the card (``chip_smoke.py`` and
``tools/regularize_sweep.py`` hold it, and every launch candidate, equal to
the plain version there).  Here the wrapper is driven through a NumPy
transcription of the shipped launch (``regularize.LAUNCH``): block by block
and warp by warp, each thread's loads (clamped addresses), for the walking
kind the rows a thread walks, the left and right neighbours taken from the
neighbouring lanes and the warp's edge lanes' own loads; then the gated
fusion of ``dvo::fuse_taps`` over what each pixel gathered.  It must equal
``regularize_plain`` bit for bit, borders and partial tiles included, and
so must every candidate of the sweep."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_tpu.config import MapperConfig as JMapperConfig
from dvo_tpu.models import mapper as jmapper
from dvo_tpu.ops.pallas.regularize import regularize_pallas
from dvo_tpu_torch.config import MapperConfig, config_from_reference
from dvo_tpu_torch.ops.cuda import _build
from dvo_tpu_torch.ops.cuda import regularize as treg
from dvo_tpu_torch.tools import regularize_sweep

torch.set_num_threads(1)

# 20x24 (one partial warp a row), 37x53 (partial warps and blocks), the
# mono path's coarser and finest levels
SHAPES = [(20, 24), (37, 53), (60, 80), (120, 160)]
F32 = np.float32


def _maps(h, w, seed=3):
    """Depth and sigma from ``regularize_sweep.maps`` (smooth depth, noise,
    outliers past the 6 m clamp, sigmas across the compatibility gate)."""
    d, s = regularize_sweep.maps(h, w, "cpu", seed)
    return d.numpy(), s.numpy()


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_regularize_plain_matches_dvo_tpu(h, w, reference):
    depth, sigma = _maps(h, w)
    cfg = JMapperConfig()
    if reference == "pallas_interpret":
        want = regularize_pallas(jnp.asarray(depth), jnp.asarray(sigma), cfg, interpret=True)
    else:
        want = jmapper.regularize(jnp.asarray(depth), jnp.asarray(sigma), cfg)
    got = treg.regularize_plain(torch.from_numpy(depth), torch.from_numpy(sigma),
                                config_from_reference(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the maps reach both branches of the gate and the clamp
    assert (got.numpy() != depth).mean() > 0.2 and (got.numpy() == depth).mean() > 0.01
    assert got.numpy().max() == np.float32(cfg.max_depth)


# ------------------------------------------------ the launch, transcribed

def _arr(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


def _gather(launch, d, s):
    """What each pixel's thread holds before ``fuse_taps`` under ``launch``:
    (nd, ns, inside) of its four taps (left, right, down, up), each (4, h,
    w), and how many threads wrote the pixel."""
    h, w = d.shape
    nd, ns = np.zeros((2, 4, h, w), F32)
    inside = np.zeros((4, h, w), bool)
    writes = np.zeros((h, w), int)
    kind, block_rows, walk = launch
    (gx, gy), (bx, by) = treg.launch_grid(h, w, launch)
    clamp = lambda v, n: np.clip(v, 0, n - 1)

    def pixel_loads(y, x):   # dvo::regularize_pixel: ten loads, clamped addresses
        for k, (dx, dy) in enumerate(((-1, 0), (1, 0), (0, 1), (0, -1))):
            qx, qy = x + dx, y + dy
            inside[k, y, x] = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
            nd[k, y, x] = d[clamp(qy, h), clamp(qx, w)]
            ns[k, y, x] = s[clamp(qy, h), clamp(qx, w)]
        writes[y, x] += 1

    if kind == "flat":
        assert gy == 1 and (bx, by) == (treg.FLAT_THREADS, 1)
        for b in range(gx):
            p = b * bx + np.arange(bx)
            p = p[p < h * w]
            pixel_loads(p // w, p % w)
        return nd, ns, inside, writes
    lanes = np.arange(32)
    for bly in range(gy):
        for blx in range(gx):
            for t in range(by):                     # one warp: 32 lanes of one row set
                x = blx * 32 + lanes
                if kind == "tile":
                    y = bly * block_rows + t
                    live = x < w
                    if y < h and live.any():
                        pixel_loads(np.full(live.sum(), y), x[live])
                    continue
                y0 = (bly * block_rows + t) * walk
                if y0 >= h:
                    continue                        # the whole warp leaves
                xc = np.minimum(x, w - 1)
                rows = [clamp(y0 - 1 + r, h) for r in range(walk + 2)]
                dv = [d[r, xc] for r in rows]       # row y0 + r is entry r + 1
                sv = [s[r, xc] for r in rows]
                # __shfl_up_sync(.., 1): lane l reads lane l - 1, lane 0 its own;
                # __shfl_down_sync(.., 1): lane l reads lane l + 1, lane 31 its own
                up = np.concatenate([[0], lanes[:-1]])
                down = np.concatenate([lanes[1:], [31]])
                dl = [dv[r + 1][up].copy() for r in range(walk)]
                sl = [sv[r + 1][up].copy() for r in range(walk)]
                dr = [dv[r + 1][down].copy() for r in range(walk)]
                sr = [sv[r + 1][down].copy() for r in range(walk)]
                for lane, xo in ((0, x[0] - 1), (31, x[31] + 1)):   # the edge lanes' loads
                    xo = clamp(xo, w)
                    for r in range(walk):
                        yq = clamp(y0 + r, h)
                        (dl if lane == 0 else dr)[r][lane] = d[yq, xo]
                        (sl if lane == 0 else sr)[r][lane] = s[yq, xo]
                for r in range(walk):
                    y = y0 + r
                    if y >= h:
                        break
                    live = x < w
                    xs = x[live]
                    for k, (a, b) in enumerate(((dl[r], sl[r]), (dr[r], sr[r]),
                                                (dv[r + 2], sv[r + 2]), (dv[r], sv[r]))):
                        nd[k, y, xs], ns[k, y, xs] = a[live], b[live]
                    inside[:, y, xs] = np.stack([xs > 0, xs + 1 < w,
                                                 np.full(xs.shape, y + 1 < h),
                                                 np.full(xs.shape, y > 0)])
                    writes[y, xs] += 1
    return nd, ns, inside, writes


def _fuse_taps(mu, sg, nd, ns, inside, gain_ramp, max_depth):
    """``dvo::fuse_taps`` over every pixel at once, in float32: the four taps
    in order, each gated, each fusion two IEEE divisions and a square root
    (ATen's ``sqrt`` on the whole map, as the plain version takes it: ATen's
    CPU ``sqrt`` is not correctly rounded everywhere; ``sqrtf`` on the card
    and a CUDA tensor's ``sqrt`` are)."""
    for k in range(4):
        diff = np.abs(nd[k] - mu)
        m = np.minimum(nd[k], diff)
        gain = np.where(m < gain_ramp, F32(0.5) + m / gain_ramp * F32(0.5), F32(1.0))
        ok = inside[k] & (diff <= gain * np.maximum(sg, ns[k]))
        v1 = sg * sg
        v2 = ns[k] * ns[k]
        v = v1 + v2
        safe_v = np.where(v < F32(1e-12), F32(1.0), v)
        mu_new = (v2 * mu + v1 * nd[k]) / safe_v
        sg_new = torch.sqrt(torch.from_numpy(v1 * v2 / safe_v)).numpy()
        mu, sg = np.where(ok, mu_new, mu), np.where(ok, sg_new, sg)
    return np.minimum(mu, max_depth)


class _EmulatedLibrary:
    """``csrc/regularize.cu``'s entries at ``launch``, transcribed."""

    def __init__(self, launch=treg.LAUNCH):
        self.launch = launch

    def dvo_regularize_kind(self):
        return treg.KINDS.index(self.launch[0])

    def dvo_regularize_block_rows(self):
        return self.launch[1]

    def dvo_regularize_thread_rows(self):
        return self.launch[2]

    def dvo_regularize(self, depth, sigma, out, h, w, gain_ramp, max_depth, stream):
        d, s = (_arr(p, h * w).reshape(h, w).copy() for p in (depth, sigma))
        nd, ns, inside, writes = _gather(self.launch, d, s)
        assert (writes == 1).all(), "a pixel written by no thread or by two"
        _arr(out, h * w)[:] = _fuse_taps(d, s, nd, ns, inside, F32(gain_ramp),
                                         F32(max_depth)).reshape(-1)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The wrapper's launch route on CPU tensors, the transcription behind it."""
    monkeypatch.setattr(treg, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", lambda: _EmulatedLibrary())
    monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
    _build.reset_launches()
    yield
    _build.reset_launches()


@pytest.mark.parametrize("h,w", SHAPES)
def test_shipped_launch_matches_plain(emulated, h, w):
    """The wrapper through the shipped launch, bit for bit the plain
    version; one launch counted."""
    depth, sigma = (torch.from_numpy(a) for a in _maps(h, w))
    got = treg.regularize(depth, sigma)
    assert _build.LAUNCHES["regularize"] == 1
    want = treg.regularize_plain(depth, sigma)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("launch", regularize_sweep.CANDIDATES, ids=regularize_sweep.label)
def test_every_candidate_matches_plain(launch):
    """Every launch of the sweep, at a shape with partial warps and blocks,
    bit for bit the plain version."""
    h, w = 37, 53
    depth, sigma = _maps(h, w, seed=5)
    out = np.empty((h, w), F32)
    lib = _EmulatedLibrary(launch)
    cfg = MapperConfig()
    lib.dvo_regularize(depth.ctypes.data, sigma.ctypes.data, out.ctypes.data, h, w,
                       cfg.depth_filter.gain_ramp, cfg.max_depth, 0)
    want = treg.regularize_plain(torch.from_numpy(depth), torch.from_numpy(sigma), cfg)
    np.testing.assert_array_equal(out, want.numpy())


def test_shipped_launch_is_a_candidate():
    """``LAUNCH`` is one of the sweep's candidates, and its grid covers every
    pixel once: at the mono shape the blocks fill the card's 132 SMs."""
    assert treg.LAUNCH in regularize_sweep.CANDIDATES
    for h, w in SHAPES + [(106, 128), (212, 256)]:
        (gx, gy), (bx, by) = treg.launch_grid(h, w)
        rows = bx * by // 32 * (treg.LAUNCH[2] if treg.LAUNCH[0] == "walk" else 1)
        assert gx * 32 >= w and gy * rows >= h
    (gx, gy), _ = treg.launch_grid(120, 160)
    assert gx * gy >= 132


def test_work():
    nbytes, flops = treg.work((120, 160))
    assert nbytes == 230_400 and flops == 73 * 19_200
