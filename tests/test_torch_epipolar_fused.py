"""The epipolar kernel's device code, transcribed to scalar NumPy float32
and held against the plain PyTorch versions bit for bit.

``csrc/epipolar.cu`` runs only on the card (``chip_smoke.py`` holds it
against the plain versions there).  What can be checked on the CPU is its
logic, operation by operation:

* ``march`` — a pixel's samples dealt to L lanes, the 3-tap SSD of window i
  taken from a shared-memory row of the samples, every lane's first strict
  minimum, and the butterfly reduction over (ssd, index) — must give
  ``march_plain``'s first minimum for L in 2, 4, 8, 16, 32, ties, all-masked
  pixels, length 0 and the 104-sample maximum included;
* ``prepare`` — the per-pixel field arithmetic of the fused entry — must
  give the planes of ``models.mapper.epipolar_fields`` (explicit sums in the
  same order);
* ``finish`` and the two C entries' argument lists: the wrappers, routed to
  their launch path on CPU tensors with the transcription behind them, must
  equal ``depth_update_by_fields`` / ``epipolar_update_plain`` exactly, on a
  ring that is full, one that is not, and one with aged-out pixels.

Every comparison here is exact (tolerance 0): both sides round each
operation to float32 in the same order.  The comparisons with ``dvo_tpu``
(1e-5 on 99.5% of pixels, counts within 1% or 2) are in
``test_torch_mapper.py``.
"""

import ctypes
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dvo_tpu_torch.config import MapperConfig
from dvo_tpu_torch.models import mapper as tmapper
from dvo_tpu_torch.models.frame import Scene
from dvo_tpu_torch.models.history import KeyframeHistory
from dvo_tpu_torch.ops.cuda import _build, epipolar

torch.set_num_threads(1)
F = np.float32
LANES = (2, 4, 8, 16, 32)


def sqrt(v):
    """ATen's CPU square root, which the plain versions take here.  Its
    vectorised kernel is not correctly rounded for every input (about one in
    a few hundred differs from IEEE ``sqrtf`` by an ulp); ``sqrtf`` on the
    card and ``torch.sqrt`` on a CUDA tensor both are.  The transcription is
    held against the CPU's plain version, so it takes the CPU's."""
    return F(torch.sqrt(torch.tensor(float(v), dtype=torch.float32)).item())


# ---------------------------------------------- csrc/dvo_kernels.h, transcribed

def to_index(v, n):
    if np.isnan(v):
        return -2
    return int(min(max(v, F(-2.0)), F(n) + F(1.0)))


def clampi(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def sample_dense(img, x, y):
    """(value, base corner in range) of ``dvo::corners`` + ``dvo::sample_dense``."""
    h, w = img.shape
    x0f, y0f = np.floor(x), np.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = to_index(x0f, w), to_index(y0f, h)
    in0 = 0 <= x0 < w and 0 <= y0 < h
    in_x1, in_y1 = x0 + 1 < w, y0 + 1 < h
    x0c, x1c = clampi(x0, 0, w - 1), clampi(x0 + 1, 0, w - 1)
    y0c, y1c = clampi(y0, 0, h - 1), clampi(y0 + 1, 0, h - 1)
    g00 = img[y0c, x0c]
    g10 = img[y0c, x1c] if in_x1 else g00
    g01 = img[y1c, x0c] if in_y1 else g00
    g11 = img[y1c, x1c] if in_x1 and in_y1 else g00
    top = g00 * (F(1.0) - fx) + g10 * fx
    bot = g01 * (F(1.0) - fx) + g11 * fx
    return top * (F(1.0) - fy) + bot * fy, in0


# ------------------------------------------ csrc/epipolar_pixel.cuh, transcribed

def load_fields(fields, y, x, capacity):
    f = fields[:, y, x]
    return SimpleNamespace(
        sx=f[0], sy=f[1], dx=f[2], dy=f[3], length=f[4], obj_v=f[5],
        slot=clampi(int(f[6]), 0, capacity - 1), prior_d=f[7], prior_s=f[8], dmin=f[9],
        dmax=f[10], r3q=f[11], krq0=f[12], krq1=f[13], krq2=f[14], ttz=f[15], kt0=f[16],
        kt1=f[17], kt2=f[18], ref_depth=f[19], ref_sigma=f[20], ref_age=int(f[21]),
        base_ok=bool(f[22] > F(0.5)), reset_d=f[23])


def warp_point(K, T, x, y, d):
    fx, cx, fy, cy = K[0], K[2], K[4], K[5]
    X = d * (x - cx) / fx
    Y = d * (y - cy) / fy
    px = T[0] * X + T[1] * Y + T[2] * d + T[9]
    py = T[3] * X + T[4] * Y + T[5] * d + T[10]
    pz = T[6] * X + T[7] * Y + T[8] * d + T[11]
    safe = F(1.0) if abs(pz) < F(1e-6) else pz
    return px * fx / safe + cx, py * fy / safe + cy, bool(pz > F(1e-6))


def prepare(raw, yb, x, h, w, y_offset, capacity):
    """``dvo::epi::prepare`` for the block's pixel (yb, x), on image row
    yb + y_offset of the h x w image: (pixel, aged_out)."""
    K, T = raw.table[0], raw.table[1]
    y = yb + y_offset
    px = SimpleNamespace(ref_depth=raw.ref_depth[yb, x], ref_sigma=raw.ref_sigma[yb, x],
                         ref_age=int(raw.ref_age[yb, x]), reset_d=raw.reset_depth[yb, x])
    crop = raw.crop_x0 <= x <= raw.crop_x1 and raw.crop_y0 <= y <= raw.crop_y1
    if not crop:        # nothing else of the pixel is computed
        px.base_ok, px.slot = False, 0
        return px, False
    u, v, in_front = warp_point(K, T, F(x), F(y), px.ref_depth)
    ox, oy = to_index(np.rint(u), w), to_index(np.rint(v), h)
    in_obj = 0 <= ox < w and 0 <= oy < h
    oxc, oyc = clampi(ox, 0, w - 1), clampi(oy, 0, h - 1)
    px.obj_v = raw.obj_gray[oyc, oxc]
    obj_ok = bool(raw.obj_mask[oyc, oxc])
    aged_ok = px.ref_age < raw.count
    pix_ok = crop and in_obj and in_front and obj_ok and aged_ok

    age = clampi(px.ref_age, 0, raw.count - 1 if raw.count > 1 else 0)
    px.slot = (raw.head - age) % capacity      # Python's % is already non-negative
    E = raw.table[2 + px.slot]

    px.prior_d = px.ref_depth - T[12]
    px.prior_s = px.ref_sigma
    oxf, oyf = F(oxc), F(oyc)
    px.dmin = max(px.prior_d - px.prior_s, F(raw.min_search_depth))
    px.dmax = px.prior_d + px.prior_s
    sx, sy, s_front = warp_point(K, E, oxf, oyf, px.dmax)
    ex, ey, e_front = warp_point(K, E, oxf, oyf, px.dmin)
    segx, segy = ex - sx, ey - sy
    px.length = sqrt(segx * segx + segy * segy + F(1e-20))
    seg_ok = bool(px.length > F(1e-6)) and s_front and e_front and bool(px.dmax > px.dmin)
    px.sx, px.sy = sx, sy
    px.dx, px.dy = segx / px.length, segy / px.length

    q0 = (oxf - K[2]) / K[0]
    q1 = (oyf - K[5]) / K[4]
    px.r3q = E[6] * q0 + E[7] * q1 + E[8]
    r0 = E[0] * q0 + E[1] * q1 + E[2]
    r1 = E[3] * q0 + E[4] * q1 + E[5]
    r2 = px.r3q
    px.krq0 = K[0] * r0 + K[1] * r1 + K[2] * r2
    px.krq1 = K[3] * r0 + K[4] * r1 + K[5] * r2
    px.krq2 = K[6] * r0 + K[7] * r1 + K[8] * r2
    t0, t1, t2 = E[12], E[13], E[14]
    px.ttz = t2
    px.kt0 = K[0] * t0 + K[1] * t1 + K[2] * t2
    px.kt1 = K[3] * t0 + K[4] * t1 + K[5] * t2
    px.kt2 = K[6] * t0 + K[7] * t1 + K[8] * t2
    px.base_ok = pix_ok and seg_ok
    return px, crop and not aged_ok


def butterfly(best, lanes):
    """The (ssd, index) minimum over the lanes by xor shuffles; every lane
    must end with the same pair."""
    off = lanes // 2
    while off > 0:
        nxt = list(best)
        for lane in range(lanes):
            o_ssd, o_s = best[lane ^ off]
            if o_ssd < best[lane][0] or (o_ssd == best[lane][0] and o_s < best[lane][1]):
                nxt[lane] = (o_ssd, o_s)
        best = nxt
        off //= 2
    assert all(b == best[0] for b in best)
    return best[0]


def march(gray, px, s, lanes):
    """``dvo::epi::march`` for a group of ``lanes`` lanes: pass 1 fills
    the row (lane l the offsets l, l + lanes, ...), pass 2 deals the windows
    the same way, then the butterfly."""
    w0, w1, w2 = F(1.0 / 3.0), F(2.0 / 3.0), F(1.0)
    n_off = int(min(np.ceil(px.length) + F(4.0), F(s.steps + 2)))
    row = [None] * (s.steps + 2)
    for lane in range(lanes):
        for o in range(lane, n_off, lanes):
            of = F(o)
            v, ok = sample_dense(gray, px.sx + of * px.dx, px.sy + of * px.dy)
            d = v - px.obj_v
            row[o] = d * d if ok else F(-1.0)
    best = [(F(s.big_ssd), 0)] * lanes
    for lane in range(lanes):
        i = lane
        while i + 2 < n_off:
            d2, d2p1, d2p2 = row[i], row[i + 1], row[i + 2]
            win_ok = d2 >= 0 and d2p1 >= 0 and d2p2 >= 0 and F(i) < px.length
            ssd = w0 * d2 + w1 * d2p1 + w2 * d2p2 if win_ok else F(s.big_ssd)
            if ssd < best[lane][0]:
                best[lane] = (ssd, i)
            i += lanes
    return butterfly(best, lanes)


def finish(px, m, ring, s, out, y, x):
    """``dvo::epi::finish``: writes the pixel's maps, returns its flags."""
    if not px.base_ok:
        out.depth[y, x], out.sigma[y, x], out.age[y, x] = px.ref_depth, px.ref_sigma, px.ref_age
        return False, False, False
    min_ssd, best_s = m
    match_ok = bool(min_ssd <= F(s.match_thresh))
    best_o = F(best_s) + F(1.0)
    mx = px.sx + best_o * px.dx
    my = px.sy + best_o * px.dy
    match_ok = match_ok and bool(mx >= 0 and my >= 0 and mx <= F(s.w) and my <= F(s.h))
    bxi, byi = to_index(np.rint(mx), s.w), to_index(np.rint(my), s.h)
    g_in = 0 <= bxi < s.w and 0 <= byi < s.h
    gy_, gx_ = clampi(byi, 0, s.h - 1), clampi(bxi, 0, s.w - 1)
    gxv, gyv = ring.gx[px.slot, gy_, gx_], ring.gy[px.slot, gy_, gx_]
    g_ok = g_in and bool(ring.gmask[px.slot, gy_, gx_])

    a0 = px.r3q * mx - px.krq0
    a1 = px.r3q * my - px.krq1
    a2 = px.r3q - px.krq2
    b0 = px.ttz * mx - px.kt0
    b1 = px.ttz * my - px.kt1
    b2 = px.ttz - px.kt2
    a_dot_a = a0 * a0 + a1 * a1 + a2 * a2
    a_dot_b = a0 * b0 + a1 * b1 + a2 * b2
    new_depth = -a_dot_b / (F(1.0) if a_dot_a < F(1e-20) else a_dot_a)

    g_dot_l = abs(gxv * (-px.dx) + gyv * (-px.dy))
    gp2 = g_dot_l / px.length
    epi = F(s.epi_sigma2) / max(g_dot_l * g_dot_l, F(1e-6))
    lum = F(s.lum_2sigma2) / max(gp2, F(1e-6))
    alpha = (px.dmax - px.dmin) / px.length
    new_sigma = alpha * sqrt(epi + lum)

    observed = (match_ok and g_ok and bool(new_depth > F(s.accept_d_lo))
                and bool(new_depth < F(s.accept_d_hi)) and bool(new_sigma > F(s.accept_s_lo))
                and bool(new_sigma < F(s.accept_s_hi)))
    mu, sg = px.prior_d, px.prior_s
    diff = abs(new_depth - mu)
    mm = min(new_depth, diff)
    gain = F(0.5) + mm / F(s.gain_ramp) * F(0.5) if mm < F(s.gain_ramp) else F(1.0)
    gate_ok = bool(diff <= gain * max(sg, new_sigma))
    accepted, rejected = gate_ok and observed, (not gate_ok) and observed
    v1, v2 = sg * sg, new_sigma * new_sigma
    v = v1 + v2
    safe_v = F(1.0) if v < F(1e-12) else v
    mu_new = (v2 * mu + v1 * new_depth) / safe_v
    sigma_new = sqrt(v1 * v2 / safe_v)
    out.depth[y, x] = mu_new if accepted else (px.reset_d if rejected else px.ref_depth)
    out.sigma[y, x] = sigma_new if accepted else (F(s.reset_sigma) if rejected
                                                  else px.ref_sigma)
    out.age[y, x] = 0 if rejected else px.ref_age
    return observed, accepted, rejected


# --------------------------------------------- csrc/epipolar.cu, transcribed

_SCALARS = ("match_thresh", "big_ssd", "epi_sigma2", "lum_2sigma2", "accept_d_lo",
            "accept_d_hi", "accept_s_lo", "accept_s_hi", "gain_ramp", "reset_sigma")


def _arr(ptr, shape, ctype):
    n = int(np.prod(shape))
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).reshape(shape)


class EmulatedLibrary:
    """The two C entries of ``csrc/epipolar.cu`` with the device code above
    behind them: each takes the raw pointers and scalars of its ctypes
    signature, in order."""

    def __init__(self, lanes):
        self.lanes = lanes

    def _run(self, pixel_of, ring, out, s):
        stats = np.zeros(4, np.int32)
        with np.errstate(all="ignore"):
            for y in range(s.bh):       # the block's rows
                for x in range(s.w):
                    px, aged_out = pixel_of(y, x)
                    m = march(ring.gray[px.slot], px, s, self.lanes) if px.base_ok else None
                    stats[:3] += finish(px, m, ring, s, out, y, x)
                    stats[3] += aged_out
        out.stats[:] = stats
        return 0

    def _common(self, ring_ptrs, out_ptrs, h, w, bh, capacity, steps, floats):
        f, u8, i32 = ctypes.c_float, ctypes.c_uint8, ctypes.c_int32
        s = SimpleNamespace(h=h, w=w, bh=bh, capacity=capacity, steps=steps,
                            **dict(zip(_SCALARS, floats)))
        gray, gx, gy, gmask = ring_ptrs
        ring = SimpleNamespace(gray=_arr(gray, (capacity, h, w), f), gx=_arr(gx, (capacity, h, w), f),
                               gy=_arr(gy, (capacity, h, w), f),
                               gmask=_arr(gmask, (capacity, h, w), u8))
        d, sg, a, st = out_ptrs
        out = SimpleNamespace(depth=_arr(d, (bh, w), f), sigma=_arr(sg, (bh, w), f),
                              age=_arr(a, (bh, w), i32), stats=_arr(st, (4,), i32))
        return s, ring, out

    def dvo_epipolar(self, fields, gray, gx, gy, gmask, depth, sigma, age, stats, h, w,
                     block_h, capacity, steps, *rest):
        *floats, stream = rest
        assert len(floats) == len(_SCALARS) and 0 <= block_h <= h
        s, ring, out = self._common((gray, gx, gy, gmask), (depth, sigma, age, stats), h, w,
                                    block_h, capacity, steps, floats)
        planes = _arr(fields, (epipolar.N_FIELDS, block_h, w), ctypes.c_float)
        return self._run(lambda y, x: (load_fields(planes, y, x, capacity), False), ring, out, s)

    def dvo_epipolar_fused(self, obj_gray, obj_mask, ref_depth, ref_sigma, ref_age, reset_depth,
                           table, gray, gx, gy, gmask, depth, sigma, age, stats, head, count,
                           h, w, block_h, y_offset, capacity, steps, cx0, cx1, cy0, cy1,
                           min_search_depth, *rest):
        *floats, stream = rest
        assert len(floats) == len(_SCALARS) and 0 <= y_offset <= h - block_h
        f = ctypes.c_float
        s, ring, out = self._common((gray, gx, gy, gmask), (depth, sigma, age, stats), h, w,
                                    block_h, capacity, steps, floats)
        bh = block_h
        raw = SimpleNamespace(
            obj_gray=_arr(obj_gray, (h, w), f), obj_mask=_arr(obj_mask, (h, w), ctypes.c_uint8),
            ref_depth=_arr(ref_depth, (bh, w), f), ref_sigma=_arr(ref_sigma, (bh, w), f),
            ref_age=_arr(ref_age, (bh, w), ctypes.c_int32),
            reset_depth=_arr(reset_depth, (bh, w), f),
            table=_arr(table, (2 + capacity, epipolar.TABLE_ROW), f),
            # head and count: one int32 each in device memory (pointers)
            head=int(_arr(head, (1,), ctypes.c_int32)[0]),
            count=int(_arr(count, (1,), ctypes.c_int32)[0]),
            crop_x0=cx0, crop_x1=cx1, crop_y0=cy0, crop_y1=cy1,
            min_search_depth=min_search_depth)
        return self._run(lambda y, x: prepare(raw, y, x, h, w, y_offset, capacity), ring, out,
                         s)


@pytest.fixture
def launch_route(monkeypatch):
    """Route the epipolar wrappers and ``depth_update`` to the launch path on
    CPU tensors, with the transcribed kernel behind them."""
    def install(lanes):
        monkeypatch.setattr(epipolar, "resolve_device", lambda _: "cuda")
        monkeypatch.setattr(tmapper, "resolve_device", lambda _: "cuda")
        monkeypatch.setattr(_build, "library", lambda: EmulatedLibrary(lanes))
        monkeypatch.setattr(_build, "stream_handle", lambda _: 0)
        _build.reset_launches()
    yield install
    _build.reset_launches()


# ------------------------------------------------------------------ the march

def _march_fields(rng, h, w, capacity):
    """Random fields built to hit the march's corners: row 0 segments with
    zero direction (every window's SSD equal: ties), row 1 segments that
    start far outside the image (all masked), row 2 length 0, row 3 the
    104-sample maximum; elsewhere lengths 0..60 in any direction.  The ring
    is quantised to 4 gray levels so that equal SSDs also occur by chance."""
    f = np.zeros((epipolar.N_FIELDS, h, w), np.float32)
    f[epipolar.F_START_X] = rng.uniform(-3, w + 3, (h, w))
    f[epipolar.F_START_Y] = rng.uniform(-3, h + 3, (h, w))
    ang = rng.uniform(0, 2 * np.pi, (h, w))
    f[epipolar.F_DIR_X], f[epipolar.F_DIR_Y] = 0.4 * np.cos(ang), 0.4 * np.sin(ang)
    f[epipolar.F_LENGTH] = rng.uniform(0, 60, (h, w))
    f[epipolar.F_OBJ_VAL] = rng.integers(0, 4, (h, w)) / 3.0
    f[epipolar.F_SLOT] = rng.integers(0, capacity, (h, w))
    f[epipolar.F_BASE_OK] = 1.0
    f[epipolar.F_DIR_X, 0] = f[epipolar.F_DIR_Y, 0] = 0.0
    f[epipolar.F_START_X, 0] = rng.uniform(1, w - 2, w)
    f[epipolar.F_START_Y, 0] = rng.uniform(1, h - 2, w)
    f[epipolar.F_START_X, 1] = -500.0
    f[epipolar.F_LENGTH, 2] = 0.0
    f[epipolar.F_LENGTH, 3] = 250.0
    f[epipolar.F_DIR_X, 3], f[epipolar.F_DIR_Y, 3] = 0.05, 0.03
    gray = (rng.integers(0, 4, (capacity, h, w)) / 3.0).astype(np.float32)
    return f, gray


@pytest.mark.parametrize("lanes", LANES)
def test_lane_strided_march_equals_plain(lanes, rng):
    """(a) the march dealt to L lanes gives ``march_plain``'s bits."""
    h, w, capacity = 8, 12, 2
    cfg = MapperConfig()
    assert cfg.max_steps + 4 == 104
    f, gray = _march_fields(rng, h, w, capacity)
    best_s, min_ssd = epipolar.march_plain(torch.from_numpy(f), torch.from_numpy(gray), cfg)
    s = SimpleNamespace(steps=cfg.max_steps + 2, big_ssd=2.0 * cfg.ssd_window)
    ties = 0
    with np.errstate(all="ignore"):
        for y in range(h):
            for x in range(w):
                px = load_fields(f, y, x, capacity)
                got_ssd, got_s = march(gray[px.slot], px, s, lanes)
                assert got_s == int(best_s[y, x]), (y, x)
                assert got_ssd == min_ssd[y, x].item(), (y, x)
                ties += got_ssd < s.big_ssd and y == 0
    assert ties > 0                                        # row 0 did match: real ties
    assert (min_ssd[1] == s.big_ssd).all() and (best_s[1] == 0).all()    # all masked
    assert (min_ssd[2] == s.big_ssd).all() and (best_s[2] == 0).all()    # length 0
    assert (min_ssd[3] < s.big_ssd).any()                  # the maximum march found matches


def test_march_breaks_ties_towards_the_first_window():
    """Equal SSDs in two different lanes and chunks: the smaller index wins."""
    gray = np.zeros((6, 40), np.float32)
    gray[:, 9:12] = 0.5            # windows 8.. see the step; before it all SSDs are equal
    px = SimpleNamespace(sx=F(0.0), sy=F(2.0), dx=F(1.0), dy=F(0.0), length=F(30.0),
                         obj_v=F(0.0))
    s = SimpleNamespace(steps=102, big_ssd=6.0)
    for lanes in LANES:
        assert march(gray, px, s, lanes) == (F(0.0), 0)
    px.obj_v = F(0.5)              # now only windows 9..9 match exactly: offsets 9, 10, 11
    for lanes in LANES:
        assert march(gray, px, s, lanes) == (F(0.0), 9)


# ------------------------------------------------- the field arithmetic, fused

def _state(rng, h, w, capacity, count, max_age):
    """A ring with ``count`` live keyframes of one textured scene seen from
    poses 2 cm apart, an object frame one step further, and reference maps
    with per-pixel ages up to ``max_age`` (>= ``count``: aged out)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    tex = lambda sh: (0.5 + 0.25 * np.sin(0.55 * (xs + sh)) * np.cos(0.4 * ys)
                      + 0.2 * np.sin(0.23 * (xs + sh) + 0.31 * ys)).astype(np.float32)
    K = torch.tensor([[1.6 * w, 0, w / 2], [0, 1.6 * w, h / 2], [0, 0, 1]])
    hist = KeyframeHistory.create(capacity, h, w)
    stacks = {k: getattr(hist, k).clone() for k in ("gray", "gx", "gy", "gmask", "mask", "xi")}
    head = -1
    for k in range(count):
        head = (head + 1) % capacity
        g = torch.from_numpy(tex(1.5 * k))
        stacks["gray"][head] = g
        stacks["gx"][head, :, 1:-1] = g[:, 2:] - g[:, :-2]
        stacks["gy"][head, 1:-1] = g[2:] - g[:-2]
        stacks["gmask"][head, 1:-1, 1:-1] = True
        stacks["mask"][head] = True
        stacks["xi"][head] = torch.tensor([-0.02 * k, 0.002 * k, 0.001 * k, 0.0, 0.002 * k, 0.0])
    hist = dataclasses.replace(hist, head=head, count=count, **stacks)
    obj_mask = torch.from_numpy(rng.random((h, w)) > 0.05)
    obj = Scene(gray=torch.from_numpy(tex(1.5 * count)), mask=obj_mask, depth=None, sigma=None,
                gx=None, gy=None, gmask=None, K=K)
    obj_xi = torch.tensor([-0.02 * count, 0.001, 0.002, 0.001, 0.002 * count, -0.001])
    rel_xi = torch.tensor([-0.02, 0.001, 0.004, 0.0005, 0.002, -0.001])
    depth = torch.from_numpy((1.2 + 0.4 * rng.random((h, w))).astype(np.float32))
    sigma = torch.from_numpy((0.05 + 0.3 * rng.random((h, w))).astype(np.float32))
    age = torch.from_numpy(rng.integers(0, max_age + 1, (h, w)).astype(np.int32))
    reset = torch.from_numpy((0.5 + 1.5 * rng.random((h, w))).astype(np.float32))
    return obj, obj_xi, rel_xi, depth, sigma, age, hist, reset


CFG = MapperConfig(crop_x=(2, 28), crop_y=(2, 20), max_steps=30, luminance_sigma=0.3,
                   epipolar_sigma=0.3, accept_sigma=(0.0, 2.0))
RINGS = [("full", 4, 4, 3), ("not_full", 4, 2, 1), ("aged_out", 4, 3, 5)]


@pytest.mark.parametrize("name,capacity,count,max_age", RINGS)
def test_field_arithmetic_equals_epipolar_fields(name, capacity, count, max_age, rng):
    """(b) ``prepare``, pixel by pixel, gives the 24 planes of
    ``epipolar_fields`` bit for bit, and the same aged-out count."""
    h, w = 24, 32
    args = _state(rng, h, w, capacity, count, max_age)
    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset = args
    fields, aged_out = tmapper.epipolar_fields(*args, CFG)
    fields = fields.numpy()
    raw = SimpleNamespace(
        obj_gray=obj.gray.numpy(), obj_mask=obj.mask.numpy(), ref_depth=depth.numpy(),
        ref_sigma=sigma.numpy(), ref_age=age.numpy(), reset_depth=reset.numpy(),
        table=tmapper.pose_table(obj.K, obj_xi, rel_xi, hist).numpy(), head=int(hist.head),
        count=int(hist.count), crop_x0=CFG.crop_x[0], crop_x1=CFG.crop_x[1], crop_y0=CFG.crop_y[0],
        crop_y1=CFG.crop_y[1], min_search_depth=CFG.min_search_depth)
    names = ("sx", "sy", "dx", "dy", "length", "obj_v", "slot", "prior_d", "prior_s", "dmin",
             "dmax", "r3q", "krq0", "krq1", "krq2", "ttz", "kt0", "kt1", "kt2", "ref_depth",
             "ref_sigma", "ref_age", "base_ok", "reset_d")
    n_ok = n_aged = 0
    with np.errstate(all="ignore"):
        for y in range(h):
            for x in range(w):
                px, aged = prepare(raw, y, x, h, w, 0, capacity)
                n_aged += aged
                n_ok += px.base_ok
                in_crop = CFG.crop_x[0] <= x <= CFG.crop_x[1] and CFG.crop_y[0] <= y <= CFG.crop_y[1]
                for k, key in enumerate(names):
                    # outside the crop the kernel stops after the four maps
                    if in_crop or key in ("ref_depth", "ref_sigma", "ref_age", "reset_d",
                                          "base_ok"):
                        assert F(getattr(px, key)) == fields[k, y, x], (key, y, x)
    assert n_aged == int(aged_out) and (n_aged > 0) == (max_age >= count)
    assert n_ok > 40


@pytest.mark.parametrize("lanes", [4, 32])
@pytest.mark.parametrize("name,capacity,count,max_age", RINGS)
def test_fused_launch_equals_the_plain_route(name, capacity, count, max_age, lanes, rng,
                                             launch_route):
    """(c) ``depth_update`` on the launch route — the pose table, the fused
    entry's argument list, ``prepare``, ``march`` and ``finish`` — against
    ``depth_update_by_fields`` on the plain route: maps, ages and all four
    counts equal."""
    args = _state(rng, 24, 32, capacity, count, max_age)
    want = tmapper.depth_update_by_fields(*args, CFG)
    launch_route(lanes)
    got = tmapper.depth_update(*args, CFG)
    assert _build.LAUNCHES["epipolar"] == 1
    for g, wnt in zip(got[:3], want[:3]):
        assert g.dtype == wnt.dtype and torch.equal(g, wnt)
    stats = lambda st: [int(getattr(st, k)) for k in ("observed", "accepted", "rejected",
                                                      "aged_out")]
    assert stats(got[3]) == stats(want[3])
    assert stats(want[3])[0] > 20 and stats(want[3])[1] > 0


@pytest.mark.parametrize("h,w", [(23, 33), (21, 29)])
def test_fused_launch_equals_the_plain_route_at_odd_shapes(h, w, rng, launch_route):
    """The same at odd heights and widths (the second: the crop reaches the
    last row and column), where no row starts on a block's boundary."""
    args = _state(rng, h, w, 4, 3, 5)
    want = tmapper.depth_update_by_fields(*args, CFG)
    launch_route(8)
    got = tmapper.depth_update(*args, CFG)
    assert _build.LAUNCHES["epipolar"] == 1
    for g, wnt in zip(got[:3], want[:3]):
        assert g.dtype == wnt.dtype and torch.equal(g, wnt)
    stats = lambda st: [int(getattr(st, k)) for k in ("observed", "accepted", "rejected",
                                                      "aged_out")]
    assert stats(got[3]) == stats(want[3]) and stats(want[3])[0] > 20


@pytest.mark.parametrize("lanes", [8])
def test_fields_launch_equals_plain(lanes, rng, launch_route):
    """The fields entry on the launch route against ``epipolar_update_plain``."""
    args = _state(rng, 24, 32, 4, 3, 5)
    hist = args[6]
    fields, _ = tmapper.epipolar_fields(*args, CFG)
    ring = (hist.gray, hist.gx, hist.gy, hist.gmask)
    want = epipolar.epipolar_update_plain(fields, *ring, CFG)
    launch_route(lanes)
    got = epipolar.epipolar_update(fields, *ring, CFG)
    assert _build.LAUNCHES["epipolar"] == 1
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype and torch.equal(g, wnt)


# ------------------------------------------------------------------- wrappers

def test_pose_table_layout(rng):
    """Rows and columns of the pose table against ``lie`` called twist by
    twist.  The table takes its three exponentials in one batched call, whose
    small matrix products may go through another library path than a single
    call's: equal to float noise (1e-7), not bit for bit."""
    obj, obj_xi, rel_xi, *_, hist, _ = _state(rng, 12, 16, 4, 3, 2)
    from dvo_tpu_torch import lie

    close = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    table = tmapper.pose_table(obj.K, obj_xi, rel_xi, hist)
    assert table.shape == (2 + 4, epipolar.TABLE_ROW) and table.dtype == torch.float32
    assert torch.equal(table[0, :9], obj.K.reshape(9))
    assert not table[0, 9:].any() and not table[:, 15].any() and not table[1, 13:].any()
    T_rel = lie.se3_exp(rel_xi)
    close(table[1, :9], T_rel[:3, :3].reshape(9))
    close(table[1, 9:12], T_rel[:3, 3])
    assert table[1, 12] == rel_xi[2]
    r_xi = lie.compose(obj_xi, -hist.xi)
    T_es = lie.se3_exp(-r_xi)
    for c in range(4):
        close(table[2 + c, :9], T_es[c, :3, :3].reshape(9))
        close(table[2 + c, 9:12], T_es[c, :3, 3])
        close(table[2 + c, 12:15], -r_xi[c, :3])


def test_fused_entry_refuses_cpu_tensors(rng):
    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset = _state(rng, 12, 16, 4, 2, 1)
    table = tmapper.pose_table(obj.K, obj_xi, rel_xi, hist)
    with pytest.raises(ValueError, match="CUDA tensors"):
        epipolar.epipolar_fused(obj.gray, obj.mask, depth, sigma, age, reset, table, hist.gray,
                                hist.gx, hist.gy, hist.gmask, hist.head, hist.count, CFG)


@pytest.mark.parametrize("change,match", [
    (lambda a: a.__setitem__("ref_age", a["ref_age"].float()), "ref_age: dtype"),
    (lambda a: a.__setitem__("obj_mask", a["obj_mask"].float()), "obj_mask: dtype"),
    (lambda a: a.__setitem__("ref_depth", a["ref_depth"].double()), "ref_depth: dtype"),
    (lambda a: a.__setitem__("reset_depth", a["reset_depth"][:, :-1]), "reset_depth: shape"),
    (lambda a: a.__setitem__("obj_gray", a["obj_gray"].T.contiguous().T), "obj_gray: not contig"),
    (lambda a: a.__setitem__("table", a["table"][:-1]), "table: shape"),
    (lambda a: a.__setitem__("born_gmask", a["born_gmask"].float()), "born_gmask: dtype"),
    (lambda a: a.__setitem__("born_gx", a["born_gx"][:, :, :-1]), "born_gx: shape"),
])
def test_fused_launch_checks_its_inputs(change, match, rng, monkeypatch):
    """On the launch route every input is checked before the library is
    touched (the kernel takes raw pointers)."""
    def no_library():
        raise AssertionError("reached the library with a bad input")

    monkeypatch.setattr(epipolar, "resolve_device", lambda _: "cuda")
    monkeypatch.setattr(_build, "library", no_library)
    obj, obj_xi, rel_xi, depth, sigma, age, hist, reset = _state(rng, 12, 12, 4, 2, 1)
    a = dict(obj_gray=obj.gray, obj_mask=obj.mask, ref_depth=depth, ref_sigma=sigma,
             ref_age=age, reset_depth=reset,
             table=tmapper.pose_table(obj.K, obj_xi, rel_xi, hist), born_gray=hist.gray,
             born_gx=hist.gx, born_gy=hist.gy, born_gmask=hist.gmask)
    change(a)
    with pytest.raises(ValueError, match=match):
        epipolar.epipolar_fused(*a.values(), hist.head, hist.count, CFG)


def test_work_counts():
    """``work()`` of both entries at the main path's shape: the fused entry
    moves 21 B in and 12 B out per pixel plus the ring and the table, the
    fields entry 108 B per pixel plus the ring."""
    n, slots, samples, c = 120 * 160, 8, 206875, 8
    nbytes, flops = epipolar.work((120, 160), slots, samples)
    assert nbytes == 108 * n + 13 * n * slots + 12
    assert flops == 27 * samples + 60 * n
    fb, ff = epipolar.work_fused((120, 160), slots, samples, c)
    assert fb == (21 + 12) * n + 13 * n * slots + 64 * (2 + c) + 16
    assert ff == 27 * samples + (60 + epipolar.FLOPS_FIELDS_PER_PIXEL) * n
    assert nbytes - fb == 75 * n - 64 * (2 + c) - 4
