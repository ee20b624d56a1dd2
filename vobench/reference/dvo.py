"""The plain reference of one visual-odometry step, in float32 PyTorch.

A frozen copy written for the benchmark, following the step of
``dvo_tpu_torch`` as of commit 4bde8663 (its plain versions: the frame
build, the coarse-to-fine Gauss-Newton tracker with its fixed-length masked
loop, the keyframe policy, propagation, the keyframe ring, the epipolar
depth update with its Gaussian filter, the regulariser) and the reference
system it ports (system.hpp, tracker.cpp, optimize.cpp, mapper.cpp,
implement.cpp, gaussian.cpp).  It imports nothing of the program: the
configuration comes in as the plain dict of the benchmark's configuration
file (``cfg``, the ``dvo`` key), the inputs as tensors.

Two steps:

* ``mono_step``: track -> pose -> keyframe decision -> (promote: propagate,
  push | update: epipolar depth update) -> regularise, as the monocular
  mode.  ``tracked_xi`` makes the step take that twist as its tracker's
  result (the judge follows the program frame by frame from its own
  poses, ``vobench/judge.py``).
* ``rgbd_track``: frame-to-frame tracking against the previous frame's
  measured depth, with the constant-velocity warm start.

No matrix product here runs in TF32 unless the caller allows it
(``torch.backends.cuda.matmul.allow_tf32``); the judge turns it off.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import torch

from vobench.reference import lie

EPS = 1e-6


def namespace(d):
    """A nested configuration dict as attributes (lists become tuples)."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    if isinstance(d, list):
        return tuple(d)
    return d


# ------------------------------------------------------------------ images

def cull(img, t: int):
    r = 2 ** t
    return img[..., ::r, ::r].contiguous()


def cull_K(K, t: int):
    if t == 0:
        return K
    K = K / (2.0 ** t)
    K[..., 2, 2] = 1.0
    return K


def gradients(gray, mask):
    gx = torch.zeros_like(gray)
    gy = torch.zeros_like(gray)
    gx[:, 1:-1] = gray[:, 2:] - gray[:, :-2]
    gy[1:-1, :] = gray[2:, :] - gray[:-2, :]
    mx = torch.zeros_like(mask)
    my = torch.zeros_like(mask)
    mx[:, 1:-1] = mask[:, 2:] & mask[:, :-2]
    my[1:-1, :] = mask[2:, :] & mask[:-2, :]
    return gx, gy, mx & my


@dataclasses.dataclass
class Level:
    gray: torch.Tensor
    mask: torch.Tensor
    depth: Optional[torch.Tensor]
    sigma: Optional[torch.Tensor]
    gx: torch.Tensor
    gy: torch.Tensor
    gmask: torch.Tensor
    K: torch.Tensor


@dataclasses.dataclass
class Frame:
    levels: tuple          # coarsest first; levels[-1] is the base
    xi: torch.Tensor       # (6,) world pose
    rel_xi: torch.Tensor   # (6,) vs the reference keyframe
    age: torch.Tensor      # (h, w) int32
    frame_id: int

    @property
    def base(self) -> Level:
        return self.levels[-1]


def build_frame(gray, mask, K, n_levels: int, culls: int, frame_id: int,
                depth=None, sigma=None) -> Frame:
    """The pyramid of a frame: the input culled by 2**culls, then every
    level culled from that base (frame.cpp:30-37), gradients not halved
    (convert.cpp:48-73).  uint8 gray is scaled to [0, 1]."""
    if gray.dtype == torch.uint8:
        gray = gray.to(torch.float32) * (1.0 / 255.0)
    gray, mask, K = cull(gray, culls), cull(mask, culls), cull_K(K, culls)
    if depth is not None:
        depth, sigma = cull(depth, culls), cull(sigma, culls)
    levels = []
    for t in range(n_levels - 1, -1, -1):
        g, m = cull(gray, t), cull(mask, t)
        gx, gy, gm = gradients(g, m)
        levels.append(Level(g, m, None if depth is None else cull(depth, t),
                            None if sigma is None else cull(sigma, t), gx, gy, gm,
                            cull_K(K, t)))
    h, w = gray.shape
    z = torch.zeros(6, dtype=torch.float32, device=gray.device)
    return Frame(tuple(levels), z, z, torch.zeros((h, w), dtype=torch.int32,
                                                  device=gray.device), frame_id)


def with_base_maps(frame: Frame, depth, sigma, age) -> Frame:
    """Every level's depth and sigma culled from new base maps."""
    n = len(frame.levels)
    levels = tuple(dataclasses.replace(lv, depth=cull(depth, n - 1 - i),
                                       sigma=cull(sigma, n - 1 - i))
                   for i, lv in enumerate(frame.levels))
    return dataclasses.replace(frame, levels=levels, age=age)


# ---------------------------------------------------------------- sampling

def _corners(x, y, w, h):
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.to(torch.int32), y0.to(torch.int32)
    in0 = (x0 >= 0) & (x0 < w) & (y0 >= 0) & (y0 < h)
    return (x0, y0, fx, fy, in0, x0 + 1 < w, y0 + 1 < h,
            torch.clamp(x0, 0, w - 1).long(), torch.clamp(x0 + 1, 0, w - 1).long(),
            torch.clamp(y0, 0, h - 1).long(), torch.clamp(y0 + 1, 0, h - 1).long())


def _pick(img, slot, y, x):
    return img[y, x] if slot is None else img[slot, y, x]


def bilinear_dense(img, x, y, slot=None):
    """getSubpixelFromDense (convert.cpp:77-105): +1 corners out of range
    fall back to the base corner; valid is the base corner's range."""
    h, w = img.shape[-2:]
    _, _, fx, fy, in0, in_x1, in_y1, x0c, x1c, y0c, y1c = _corners(x, y, w, h)
    g00 = _pick(img, slot, y0c, x0c)
    g10 = torch.where(in_x1, _pick(img, slot, y0c, x1c), g00)
    g01 = torch.where(in_y1, _pick(img, slot, y1c, x0c), g00)
    g11 = torch.where(in_x1 & in_y1, _pick(img, slot, y1c, x1c), g00)
    top = g00 * (1.0 - fx) + g10 * fx
    bot = g01 * (1.0 - fx) + g11 * fx
    return top * (1.0 - fy) + bot * fy, in0


def bilinear_masked(img, mask, x, y):
    """getSubpixel (convert.cpp:128-177): invalid corners take the nearest
    valid one in the cyclic order; all four invalid -> invalid."""
    h, w = img.shape
    _, _, fx, fy, in0, in_x1, in_y1, x0c, x1c, y0c, y1c = _corners(x, y, w, h)
    in3 = in_x1 & in_y1
    g00, m00 = img[y0c, x0c], mask[y0c, x0c]
    g = [g00, torch.where(in_x1, img[y0c, x1c], g00), torch.where(in_y1, img[y1c, x0c], g00),
         torch.where(in3, img[y1c, x1c], g00)]
    v = [in0 & m00, in0 & torch.where(in_x1, mask[y0c, x1c], m00),
         in0 & torch.where(in_y1, mask[y1c, x0c], m00), in0 & torch.where(in3, mask[y1c, x1c], m00)]
    g = [torch.where(vi, gi, 0.0) for gi, vi in zip(g, v)]
    for _ in range(2):
        for i in range(4):
            p = (i - 1) % 4
            take = (~v[i]) & v[p]
            g[i] = torch.where(take, g[p], g[i])
            v[i] = v[i] | take
    top = g[0] * (1.0 - fx) + g[1] * fx
    bot = g[2] * (1.0 - fx) + g[3] * fx
    return top * (1.0 - fy) + bot * fy, v[0] | v[1] | v[2] | v[3]


def pixel_grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    return xs, ys


def back_project(K, xs, ys, depth):
    return torch.stack([depth * (xs - K[0, 2]) / K[0, 0], depth * (ys - K[1, 2]) / K[1, 1],
                        depth], -1)


def project(K, pts):
    z = pts[..., 2]
    safe = torch.where(torch.abs(z) < EPS, 1.0, z)
    return pts[..., 0] * K[0, 0] / safe + K[0, 2], pts[..., 1] * K[1, 1] / safe + K[1, 2], z > EPS


# ----------------------------------------------------------------- tracker

def gn_terms(obj: Level, ref: Level, T_inv, level_index: int, tc):
    """The normal equations of one linearisation (optimize.cpp:28-94), the
    weight on both sides.  Returns (H, g, residual_sum, count)."""
    h, w = obj.gray.shape
    K = ref.K
    xs, ys = pixel_grid(h, w, obj.gray.device)
    depth = ref.depth
    pts = back_project(K, xs, ys, depth)
    wx, wy, in_front = project(K, lie.transform(T_inv, pts))
    i2, i2_ok = bilinear_masked(ref.gray, ref.mask, wx, wy)
    gx, _ = bilinear_dense(ref.gx, wx, wy)
    gy, _ = bilinear_dense(ref.gy, wx, wy)
    gm, _ = bilinear_dense(ref.gmask.to(torch.float32), wx, wy)
    valid = (depth >= tc.min_depth) & obj.mask & i2_ok
    valid = valid & (wx >= 0) & (wx < w) & (wy >= 0) & (wy < h) & in_front & (gm > 1.0 - 1e-4)
    if level_index == tc.crop_level:
        valid = valid & (xs >= tc.crop_x[0]) & (xs <= tc.crop_x[1]) \
            & (ys >= tc.crop_y[0]) & (ys <= tc.crop_y[1])
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    fgx, fgy = K[0, 0] * gx, K[1, 1] * gy
    xz, yz = x / z, y / z
    J = torch.stack([fgx / z, fgy / z, -(fgx * x + fgy * y) / (z * z),
                     -fgx * xz * yz - fgy * (1.0 + yz * yz),
                     fgx * (1.0 + xz * xz) + fgy * xz * yz, -fgx * yz + fgy * xz], -1)
    r = i2 - obj.gray
    step = tc.level_steps[min(level_index, len(tc.level_steps) - 1)]
    weight = step / torch.clamp(ref.sigma, tc.sigma_clamp[0], tc.sigma_clamp[1])
    vf = valid.to(torch.float32)
    Jm = J * vf[..., None]
    wf = weight * vf
    if tc.compat_weight_b_only:
        H = torch.einsum("hwi,hwj->ij", Jm, Jm)
    else:
        H = torch.einsum("hwi,hwj->ij", Jm * wf[..., None], Jm)
    g = torch.einsum("hwi,hw->i", Jm, r * (weight * vf if tc.compat_weight_b_only else wf))
    return H, g, torch.sum(r * r * vf), torch.sum(valid.to(torch.int32))


def gn_level(obj: Level, ref: Level, xi0, level_index: int, tc):
    """At most ``max_iterations`` GN steps (tracker.cpp:22-84): the solve
    (H + damping I) delta = g, xi <- compose(xi, delta) unless not finite,
    and a stop after the update when the update norm or the mean residual
    is small or no pixel was valid.  Returns (xi, residuals, update norms,
    valid counts, iterations), the statistics zero past the last step."""
    xi = xi0
    done = torch.zeros((), dtype=torch.bool, device=xi0.device)
    eye = torch.eye(6, dtype=torch.float32, device=xi0.device)
    res, upd, cnt, active = [], [], [], []
    for _ in range(tc.max_iterations):
        H, g, rsum, count = gn_terms(obj, ref, lie.se3_exp(-xi), level_index, tc)
        L, info = torch.linalg.cholesky_ex(H + tc.damping * eye)
        delta = torch.cholesky_solve(g[:, None], L)[:, 0]
        delta = torch.where(info == 0, delta, torch.nan)
        delta = torch.where(count > 0, delta, 0.0)
        new = lie.compose(xi, delta)
        new = torch.where(torch.all(torch.isfinite(new)), new, xi)
        mean = torch.where(count > 0, rsum / torch.clamp(count, min=1), -1.0)
        u = torch.linalg.vector_norm(delta)
        conv = (u < tc.min_update_norm) | (mean < tc.min_residual) | (count == 0)
        xi = torch.where(done, xi, new)
        res.append(torch.where(done, 0.0, mean))
        upd.append(torch.where(done, 0.0, u))
        cnt.append(torch.where(done, 0, count))
        active.append(~done)
        done = done | conv
        if bool(done):
            # the masked steps that would follow change nothing: stop
            break
    pad = tc.max_iterations - len(res)
    res, upd, cnt = (torch.cat([torch.stack(x), torch.zeros(pad, dtype=x[0].dtype,
                                                            device=xi.device)])
                     for x in (res, upd, cnt))
    return xi, res, upd, cnt, torch.stack(active).sum().to(torch.int32)


def track(obj: Frame, ref: Frame, tc, xi0=None):
    """Coarsest to finest, xi carried across levels.  Returns a dict of xi
    (6,), residuals, update_norms, valid_counts (levels, iters) and
    iterations (levels,)."""
    xi = torch.zeros(6, dtype=torch.float32, device=ref.xi.device) if xi0 is None else xi0
    out = {"residuals": [], "update_norms": [], "valid_counts": [], "iterations": []}
    for i, (o, r) in enumerate(zip(obj.levels, ref.levels)):
        xi, res, upd, cnt, it = gn_level(o, r, xi, i, tc)
        for k, v in zip(out, (res, upd, cnt, it)):
            out[k].append(v)
    out = {k: torch.stack(v) for k, v in out.items()}
    out["xi"] = xi
    return out


def mean_residual(obj: Frame, ref: Frame, xi, tc, level: int = -1):
    """The mean squared photometric residual at twist ``xi`` on one level
    (default: the base) and its valid count."""
    index = level % len(ref.levels)
    _, _, rsum, count = gn_terms(obj.levels[index], ref.levels[index], lie.se3_exp(-xi),
                                 index, tc)
    return rsum / torch.clamp(count, min=1), count


# ------------------------------------------------------------------ mapper

def need_new_keyframe(rel_xi, frame_id: int, ref_id: int, mc):
    """mapper.cpp:45-60: moved farther than ``min_movement`` or
    ``max_forward`` frames since the keyframe."""
    moved = torch.linalg.vector_norm(rel_xi[:3]) > mc.min_movement
    return moved | torch.tensor(frame_id - ref_id >= mc.max_forward, device=rel_xi.device)


def propagate(depth, sigma, age, rel_xi, K, mc, init):
    """Forward-warp the keyframe's maps into the new keyframe
    (implement.cpp:217-256): the nearest source wins, ties by raster id;
    unwritten pixels take the init depth and sigma and age 0."""
    h, w = depth.shape
    xs, ys = pixel_grid(h, w, depth.device)
    u, v, front = project(K, lie.transform(lie.se3_exp(rel_xi), back_project(K, xs, ys, depth)))
    tx, ty = torch.round(u).to(torch.int32), torch.round(v).to(torch.int32)
    valid = (torch.abs(depth) >= EPS) & front & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    d0 = torch.clamp(depth, min=0.01)
    d1 = d0 + rel_xi[2]
    ratio = d1 / d0
    s1 = torch.sqrt(ratio ** 4 * sigma ** 2 + mc.predict_sigma ** 2)
    d1 = torch.clamp(d1, min=0.0)
    n = h * w
    big = torch.iinfo(torch.int64).max
    src = torch.arange(n, dtype=torch.int64, device=depth.device)
    tgt = torch.where(valid, ty * w + tx, n).reshape(-1).long()
    dq = torch.clamp(torch.round(d1 * 4096.0), 0, 65535).to(torch.int64)
    key = torch.where(valid.reshape(-1), (dq.reshape(-1) << 32) | src, big)
    slots = torch.full((n + 1,), big, dtype=torch.int64, device=depth.device)
    slots.scatter_reduce_(0, tgt, key, reduce="amin")
    written = slots[:n] != big
    win = torch.where(written, slots[:n] & 0xFFFFFFFF, 0)
    return (torch.where(written, d1.reshape(-1)[win], init.propagate_depth).reshape(h, w),
            torch.where(written, s1.reshape(-1)[win], init.propagate_sigma).reshape(h, w),
            torch.where(written, (age + 1).reshape(-1)[win], 0).reshape(h, w).to(torch.int32))


def _gate(mu, sigma, d, s, fc):
    diff = torch.abs(d - mu)
    m = torch.minimum(d, diff)
    gain = torch.where(m < fc.gain_ramp, 0.5 + m / fc.gain_ramp * 0.5, 1.0)
    return diff <= gain * torch.maximum(sigma, s)


def _fuse(mu, sigma, d, s):
    v1, v2 = sigma * sigma, s * s
    v = v1 + v2
    safe = torch.where(v < 1e-12, 1.0, v)
    return (v2 * mu + v1 * d) / safe, torch.sqrt(v1 * v2 / safe)


def regularize(depth, sigma, mc):
    """Fuse the left, right, lower and upper neighbours of the original
    maps into each pixel (implement.cpp:160-178); clamp to max_depth."""
    h, w = depth.shape
    mu, sg = depth, sigma
    for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
        nd = torch.zeros_like(depth)
        ns = torch.ones_like(sigma)
        ok = torch.zeros((h, w), dtype=torch.bool, device=depth.device)
        y0, y1, x0, x1 = max(-dy, 0), h + min(-dy, 0), max(-dx, 0), w + min(-dx, 0)
        nd[y0:y1, x0:x1] = depth[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
        ns[y0:y1, x0:x1] = sigma[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
        ok[y0:y1, x0:x1] = True
        accept = _gate(mu, sg, nd, ns, mc.depth_filter) & ok
        fm, fs = _fuse(mu, sg, nd, ns)
        mu, sg = torch.where(accept, fm, mu), torch.where(accept, fs, sg)
    return torch.clamp(mu, max=mc.max_depth)


@dataclasses.dataclass
class Ring:
    """The keyframe ring: (C, h, w) stacks, poses, ids, head and count."""
    gray: torch.Tensor
    mask: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    gmask: torch.Tensor
    depth: torch.Tensor
    sigma: torch.Tensor
    xi: torch.Tensor
    kf_id: torch.Tensor
    head: int
    count: int

    @property
    def capacity(self) -> int:
        return self.gray.shape[0]


def ring_push(ring: Ring, frame: Frame, depth, sigma) -> Ring:
    slot = (ring.head + 1) % ring.capacity
    new = dataclasses.replace(ring, head=slot, count=min(ring.count + 1, ring.capacity))
    for name, value in (("gray", frame.base.gray), ("mask", frame.base.mask),
                        ("gx", frame.base.gx), ("gy", frame.base.gy),
                        ("gmask", frame.base.gmask), ("depth", depth), ("sigma", sigma),
                        ("xi", frame.xi)):
        stack = getattr(ring, name).clone()
        stack[slot] = value
        setattr(new, name, stack)
    new.kf_id = ring.kf_id.clone()
    new.kf_id[slot] = frame.frame_id
    return new


def ring_refresh(ring: Ring, frame: Frame) -> Ring:
    new = dataclasses.replace(ring)
    for name, value in (("depth", frame.base.depth), ("sigma", frame.base.sigma),
                        ("xi", frame.xi)):
        stack = getattr(ring, name).clone()
        stack[ring.head] = value
        setattr(new, name, stack)
    return new


def _warp_point(K, T, x, y, d):
    """project(K, R back_project(K, (x, y), d) + t), each product an
    explicit sum.  ``T``: R row-major at 0..8, t at 9..11."""
    fx, cx, fy, cy = K[0, 0], K[0, 2], K[1, 1], K[1, 2]
    X = d * (x - cx) / fx
    Y = d * (y - cy) / fy
    px = T[0] * X + T[1] * Y + T[2] * d + T[9]
    py = T[3] * X + T[4] * Y + T[5] * d + T[10]
    pz = T[6] * X + T[7] * Y + T[8] * d + T[11]
    safe = torch.where(torch.abs(pz) < EPS, 1.0, pz)
    return px * fx / safe + cx, py * fy / safe + cy, pz > EPS


def _rows(T):
    """A (..., 4, 4) transform as 12 values per entry: R row-major, t."""
    return torch.cat([T[..., :3, :3].reshape(T.shape[:-2] + (9,)), T[..., :3, 3]], -1)


def depth_update(obj: Level, obj_xi, rel_xi, depth, sigma, age, ring: Ring, reset_depth, mc):
    """The epipolar observation and the depth filter of every reference
    pixel (mapper.cpp:76-137, implement.cpp:25-152): the pixel's match in
    the object frame, the epipolar segment in the keyframe its depth was
    born in, an SSD march along it, triangulation, the sigma model, the
    gates, fusion with reset.  Returns (depth, sigma, age, observed)."""
    h, w = depth.shape
    dev = depth.device
    K = obj.K
    xs, ys = pixel_grid(h, w, dev)
    T_rel = _rows(lie.se3_exp(rel_xi)).unbind(-1)
    u, v, front = _warp_point(K, T_rel, xs, ys, depth)
    ox, oy = torch.round(u).to(torch.int32), torch.round(v).to(torch.int32)
    in_obj = (ox >= 0) & (ox < w) & (oy >= 0) & (oy < h)
    oxc, oyc = torch.clamp(ox, 0, w - 1).long(), torch.clamp(oy, 0, h - 1).long()
    obj_val, obj_ok = obj.gray[oyc, oxc], obj.mask[oyc, oxc]
    crop = (xs >= mc.crop_x[0]) & (xs <= mc.crop_x[1]) & (ys >= mc.crop_y[0]) & (ys <= mc.crop_y[1])
    pix_ok = crop & in_obj & front & obj_ok & (age < ring.count)
    # the keyframe each pixel's depth was born in, and its pose
    a = torch.minimum(torch.clamp(age, min=0), torch.tensor(max(ring.count - 1, 0), device=dev))
    slot = torch.remainder(ring.head - a, ring.capacity).long()
    r_xi = lie.compose(obj_xi[None].expand(ring.capacity, 6), -ring.xi)    # (C, 6)
    E_all = torch.cat([_rows(lie.se3_exp(-r_xi)), -r_xi[:, :3]], -1)      # (C, 15)
    E = E_all[slot].unbind(-1)
    prior_d = depth - rel_xi[2]
    prior_s = sigma
    oxf, oyf = oxc.to(torch.float32), oyc.to(torch.float32)
    dmin = torch.clamp(prior_d - prior_s, min=mc.min_search_depth)
    dmax = prior_d + prior_s
    sx, sy, s_front = _warp_point(K, E, oxf, oyf, dmax)
    ex, ey, e_front = _warp_point(K, E, oxf, oyf, dmin)
    segx, segy = ex - sx, ey - sy
    length = torch.sqrt(segx * segx + segy * segy + 1e-20)
    base_ok = pix_ok & (length > 1e-6) & s_front & e_front & (dmax > dmin)
    dx, dy = segx / length, segy / length
    # the march: windows of three samples along the segment (implement.cpp:106-152)
    S = mc.max_steps + 2
    o = torch.arange(0, S + 2, dtype=torch.float32, device=dev)[:, None, None]
    samp, samp_ok = bilinear_dense(ring.gray, sx + o * dx, sy + o * dy, slot=slot)
    d2 = (samp - obj_val) ** 2
    ssd = (1.0 / 3.0) * d2[:S] + (2.0 / 3.0) * d2[1:S + 1] + 1.0 * d2[2:S + 2]
    win_ok = samp_ok[:S] & samp_ok[1:S + 1] & samp_ok[2:S + 2]
    in_march = torch.arange(0, S, dtype=torch.float32, device=dev)[:, None, None] < length
    ssd = torch.where(win_ok & in_march, ssd, 2.0 * mc.ssd_window)
    best = torch.argmin(ssd, dim=0)
    min_ssd = torch.gather(ssd, 0, best[None])[0]
    bo = (best + 1).to(torch.float32)
    mx, my = sx + bo * dx, sy + bo * dy
    match_ok = (min_ssd <= mc.ssd_window * mc.matching_threshold_ratio) \
        & (mx >= 0) & (my >= 0) & (mx <= w) & (my <= h)
    bx, by = torch.round(mx).to(torch.int32), torch.round(my).to(torch.int32)
    g_in = (bx >= 0) & (bx < w) & (by >= 0) & (by < h)
    bxc, byc = torch.clamp(bx, 0, w - 1).long(), torch.clamp(by, 0, h - 1).long()
    gxv, gyv = ring.gx[slot, byc, bxc], ring.gy[slot, byc, bxc]
    g_ok = g_in & ring.gmask[slot, byc, bxc]
    # triangulation (implement.cpp:49-71)
    q0, q1 = (oxf - K[0, 2]) / K[0, 0], (oyf - K[1, 2]) / K[1, 1]
    r3q = E[6] * q0 + E[7] * q1 + E[8]
    r0 = E[0] * q0 + E[1] * q1 + E[2]
    r1 = E[3] * q0 + E[4] * q1 + E[5]
    KRq = [K[i, 0] * r0 + K[i, 1] * r1 + K[i, 2] * r3q for i in range(3)]
    t_tw = E[12:15]
    Kt = [K[i, 0] * t_tw[0] + K[i, 1] * t_tw[1] + K[i, 2] * t_tw[2] for i in range(3)]
    a0, a1, a2 = r3q * mx - KRq[0], r3q * my - KRq[1], r3q - KRq[2]
    b0, b1, b2 = t_tw[2] * mx - Kt[0], t_tw[2] * my - Kt[1], t_tw[2] - Kt[2]
    aa = a0 * a0 + a1 * a1 + a2 * a2
    new_d = -(a0 * b0 + a1 * b1 + a2 * b2) / torch.where(aa < 1e-20, 1.0, aa)
    # sigma model (implement.cpp:73-104)
    g_dot_l = torch.abs(gxv * (-dx) + gyv * (-dy))
    gp2 = g_dot_l / length
    epi = torch.full_like(g_dot_l, mc.epipolar_sigma ** 2) / torch.clamp(g_dot_l * g_dot_l, min=EPS)
    lum = torch.full_like(gp2, 2.0 * mc.luminance_sigma ** 2) / torch.clamp(gp2, min=EPS)
    new_s = (dmax - dmin) / length * torch.sqrt(epi + lum)
    obs = base_ok & match_ok & g_ok & (new_d > mc.accept_depth[0]) & (new_d < mc.accept_depth[1]) \
        & (new_s > mc.accept_sigma[0]) & (new_s < mc.accept_sigma[1])
    # fusion, or a reset where the observation is incompatible (gaussian.cpp)
    fc = mc.depth_filter
    gate = _gate(prior_d, prior_s, new_d, new_s, fc)
    ok, rejected = gate & obs, ~gate & obs
    fm, fs = _fuse(prior_d, prior_s, new_d, new_s)
    mu = torch.where(ok, fm, torch.where(rejected, reset_depth, prior_d))
    sg = torch.where(ok, fs, torch.where(rejected, fc.reset_sigma, prior_s))
    return (torch.where(obs, mu, depth), torch.where(obs, sg, sigma),
            torch.where(rejected, 0, age).to(torch.int32), int(obs.sum()))


# -------------------------------------------------------------------- steps

@dataclasses.dataclass
class MonoState:
    ring: Ring
    ref: Frame
    frame_count: int
    prev_rel: torch.Tensor
    vel: torch.Tensor


def mono_xi0(state: MonoState, tc):
    """The tracker's start: the constant-velocity prior where the warm
    start is on and the prior is short enough, else None (identity)."""
    if not tc.warm_start:
        return None
    xi0 = lie.compose(state.prev_rel, state.vel)
    return torch.where(torch.linalg.vector_norm(xi0) < tc.warm_start_max_norm, xi0, 0.0)


def mono_step(state: MonoState, gray, mask, K, cfg, reset_depth, tracked_xi=None):
    """One monocular frame (system.hpp:44-74).  ``cfg``: the configuration's
    namespace; ``reset_depth``: the depth filter's reset plane at the base
    size; ``tracked_xi``: a twist to take as the tracker's result instead
    of tracking (None: track).  Returns (state', a dict with T_world,
    rel_xi, is_keyframe, observed and, where it tracked, tracking)."""
    pc, tc, mc = cfg.pyramid, cfg.tracker, cfg.mapper
    frame = build_frame(gray, mask, K, pc.levels, pc.culls, state.frame_count)
    ref = state.ref
    tracking = None
    if tracked_xi is None:
        tracking = track(frame, ref, tc, mono_xi0(state, tc))
        xi = tracking["xi"]
    else:
        xi = tracked_xi
    frame = dataclasses.replace(frame, rel_xi=xi, xi=lie.compose(ref.xi, xi))
    vel = lie.compose(-state.prev_rel, xi)
    kf = bool(need_new_keyframe(xi, frame.frame_id, ref.frame_id, mc))
    base = ref.base
    if kf:
        d, s, age = propagate(base.depth, base.sigma, ref.age, frame.rel_xi, base.K, mc, cfg.init)
        ring = ring_push(ring_refresh(state.ring, ref), frame, d, s)
        new_ref, observed = frame, 0
    else:
        d, s, age, observed = depth_update(frame.base, frame.xi, frame.rel_xi, base.depth,
                                           base.sigma, ref.age, state.ring, reset_depth, mc)
        ring, new_ref = state.ring, ref
    new_ref = with_base_maps(new_ref, d, s, age)
    new_ref = with_base_maps(new_ref, regularize(new_ref.base.depth, new_ref.base.sigma, mc),
                             s, age)
    new_state = MonoState(ring, new_ref, state.frame_count + 1,
                          torch.zeros_like(xi) if kf else xi, vel)
    return new_state, {"T_world": lie.se3_exp(new_ref.xi if kf else frame.xi), "rel_xi": xi,
                       "is_keyframe": kf, "observed": observed, "tracking": tracking}


def raw_depth(counts, depth_scale: float, depth_sigma: float):
    """Sensor counts -> (depth [m], sigma): counts times the float32 of
    1 / depth_scale; sigma ``depth_sigma`` where measured, 1 where not."""
    scale = torch.tensor(1.0 / depth_scale, dtype=torch.float32).item()
    depth = counts.to(torch.float32) * scale
    return depth, torch.where(depth > 1e-6, depth_sigma, 1.0).to(torch.float32)


def rgbd_frame(gray, mask, counts, K, cfg, frame_id: int, depth_scale: float,
               depth_sigma: float) -> Frame:
    pc = cfg.pyramid
    depth, sigma = raw_depth(cull(counts, pc.culls), depth_scale, depth_sigma)
    frame = build_frame(cull(gray, pc.culls), cull(mask, pc.culls), cull_K(K, pc.culls),
                        pc.levels, 0, frame_id, depth, sigma)
    return frame


def rgbd_track(prev: Frame, frame: Frame, vel, cfg):
    """Track ``frame`` against ``prev`` with the warm start from ``vel``
    (system.hpp:77-93).  Returns the tracking dict."""
    tc = cfg.tracker
    xi0 = None
    if tc.warm_start:
        xi0 = torch.where(torch.linalg.vector_norm(vel) < tc.warm_start_max_norm, vel, 0.0)
    return track(frame, prev, tc, xi0)


def mono_init(gray, mask, K, cfg, noise) -> MonoState:
    """The first frame as the keyframe at identity, its depth the noise
    bootstrap max(mean + std * noise, floor) and sigma ``init.sigma``
    (frame.hpp:12-22), the only entry of an empty ring."""
    pc, ic = cfg.pyramid, cfg.init
    frame = build_frame(gray, mask, K, pc.levels, pc.culls, 0)
    h, w = frame.base.gray.shape
    depth = torch.clamp(ic.depth_mean + ic.depth_std * noise, min=ic.depth_floor)
    sigma = torch.full((h, w), ic.sigma, dtype=torch.float32, device=depth.device)
    frame = with_base_maps(frame, depth, sigma, frame.age)
    c, dev = cfg.mapper.history_capacity, depth.device
    f32 = dict(dtype=torch.float32, device=dev)
    ring = Ring(gray=torch.zeros((c, h, w), **f32),
                mask=torch.zeros((c, h, w), dtype=torch.bool, device=dev),
                gx=torch.zeros((c, h, w), **f32), gy=torch.zeros((c, h, w), **f32),
                gmask=torch.zeros((c, h, w), dtype=torch.bool, device=dev),
                depth=torch.zeros((c, h, w), **f32), sigma=torch.ones((c, h, w), **f32),
                xi=torch.zeros((c, 6), **f32),
                kf_id=torch.full((c,), -1, dtype=torch.int32, device=dev), head=-1, count=0)
    zeros = torch.zeros(6, **f32)
    return MonoState(ring_push(ring, frame, depth, sigma), frame, 1, zeros, zeros)
