"""Slow, scalar NumPy oracle of the reference algorithms —
``dvo_tpu.utils.oracle`` copied (NumPy only, float64).

It states the reference's behavioural contract in the most literal scalar
form (per-pixel Python loops, the INVALID sentinel and all).  The port uses
its Lie algebra on the host: the pose-graph harvester's per-node and
per-edge exp/log/compose run here in float64 instead of as one device
operation each (``models/posegraph``).  The rest is kept so that the copy
stays whole and is held against the original at tolerance 0
(``tests/test_torch_posegraph.py``).

Each function cites the reference source it reproduces.
"""

from __future__ import annotations

import numpy as np

INVALID = -2.0
EPSILON = 1e-6


def is_valid(v) -> bool:
    return v > INVALID


# ---------------------------------------------------------------- Lie algebra

def hat(w):
    return np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=np.float64
    )


def so3_exp(w):
    """Rodrigues (reference delegates to cv::Rodrigues, se3.cpp:21-28)."""
    th = np.linalg.norm(w)
    W = hat(w)
    if th < 1e-12:
        return np.eye(3) + W
    return (
        np.eye(3)
        + np.sin(th) / th * W
        + (1.0 - np.cos(th)) / (th * th) * (W @ W)
    )


def so3_log(R):
    """Reference se3.cpp:31-43."""
    tr = np.trace(R)
    c = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(c)
    if th <= 1e-6:
        return np.zeros(3)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2.0 * np.sin(th)) * vee


def se3_exp(xi):
    """Reference se3.cpp:70-98 (t = v below the small-angle threshold)."""
    v, w = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(w)
    R = so3_exp(w)
    if th > 1e-6:
        W = hat(w)
        V = (
            np.eye(3)
            + W * (1.0 - np.cos(th)) / (th * th)
            + (W @ W) * (th - np.sin(th)) / (th ** 3)
        )
        t = V @ v
    else:
        t = v
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def se3_log(T):
    """Reference se3.cpp:101-124."""
    R = T[:3, :3]
    t = T[:3, 3]
    w = so3_log(R)
    th = np.linalg.norm(w)
    V_inv = np.eye(3)
    if th > 1e-6:
        W = hat(w)
        V_inv = (
            np.eye(3)
            - 0.5 * W
            + (1.0 - (th * np.cos(th * 0.5)) / (2.0 * np.sin(th * 0.5)))
            * (W @ W)
            / (th * th)
        )
    v = V_inv @ t
    return np.concatenate([v, w])


def compose(xi0, xi1):
    """Reference se3::concatenate, se3.cpp:127-131."""
    return se3_log(se3_exp(xi0) @ se3_exp(xi1))


# ------------------------------------------------------------------ image ops

def cull_image(img, times):
    """Point-sampled decimation (convert.cpp:7-20)."""
    if times == 0:
        return img.copy()
    r = 2 ** times
    h, w = img.shape[0] // r, img.shape[1] // r
    return img[: h * r : r, : w * r : r].copy()


def cull_intrinsic(K, times):
    if times == 0:
        return K.copy()
    K2 = K / (2 ** times)
    K2[2, 2] = 1.0
    return K2


def gradiate(gray, x_dir):
    """Central difference, not halved; INVALID at borders and where either
    neighbor is invalid (convert.cpp:41-75)."""
    h, w = gray.shape
    out = np.full((h, w), INVALID, np.float32)
    for yy in range(h):
        for xx in range(w):
            if x_dir:
                if xx - 1 < 0 or xx + 1 >= w:
                    continue
                a, b = gray[yy, xx - 1], gray[yy, xx + 1]
            else:
                if yy - 1 < 0 or yy + 1 >= h:
                    continue
                a, b = gray[yy - 1, xx], gray[yy + 1, xx]
            if not (is_valid(a) and is_valid(b)):
                continue
            out[yy, xx] = b - a
    return out


def get_subpixel_from_dense(img, x, y):
    """convert.cpp:77-105: plain bilinear; out-of-range +1 corners reuse the
    base corner; out-of-range base -> INVALID."""
    h, w = img.shape
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    if not (0 <= x0 < w and 0 <= y0 < h):
        return INVALID
    fx, fy = x - x0, y - y0
    g = [img[y0, x0]] * 4
    if x0 + 1 < w:
        g[1] = img[y0, x0 + 1]
    if y0 + 1 < h:
        g[2] = img[y0 + 1, x0]
    if x0 + 1 < w and y0 + 1 < h:
        g[3] = img[y0 + 1, x0 + 1]
    return (g[0] * (1 - fx) + g[1] * fx) * (1 - fy) + (
        g[2] * (1 - fx) + g[3] * fx
    ) * fy


def get_subpixel(img, x, y):
    """convert.cpp:128-177: bilinear over possibly-INVALID images, invalid
    corners filled from the nearest valid corner in cyclic order 0,1,2,3;
    all-invalid -> INVALID.  (The reference's `last > 0` quirk is modeled as
    `valid`, matching the fixed behavior asserted by the JAX path.)"""
    h, w = img.shape
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    if not (0 <= x0 < w and 0 <= y0 < h):
        return INVALID
    fx, fy = x - x0, y - y0
    g = [img[y0, x0]] * 4
    v = [is_valid(g[0])] * 4
    if x0 + 1 < w:
        g[1] = img[y0, x0 + 1]
        v[1] = is_valid(g[1])
    if y0 + 1 < h:
        g[2] = img[y0 + 1, x0]
        v[2] = is_valid(g[2])
    if x0 + 1 < w and y0 + 1 < h:
        g[3] = img[y0 + 1, x0 + 1]
        v[3] = is_valid(g[3])
    if not any(v):
        return INVALID
    for _ in range(2):
        for i in range(4):
            p = (i - 1) % 4
            if not v[i] and v[p]:
                g[i] = g[p]
                v[i] = True
    return (g[0] * (1 - fx) + g[1] * fx) * (1 - fy) + (
        g[2] * (1 - fx) + g[3] * fx
    ) * fy


# ------------------------------------------------------------------- geometry

def project(K, p):
    return np.array([p[0] * K[0, 0] / p[2] + K[0, 2], p[1] * K[1, 1] / p[2] + K[1, 2]])


def back_project(K, x, y, depth):
    return np.array(
        [depth * (x - K[0, 2]) / K[0, 0], depth * (y - K[1, 2]) / K[1, 1], depth]
    )


def warp_point(xi, x, y, depth, K):
    """transform.cpp:30-33."""
    T = se3_exp(xi)
    p = T[:3, :3] @ back_project(K, x, y, depth) + T[:3, 3]
    return project(K, p)


def warp_image(xi, gray, depth, K):
    """Inverse warping by -xi (transform.cpp:35-51)."""
    h, w = gray.shape
    out = np.full((h, w), INVALID, np.float32)
    for yy in range(h):
        for xx in range(w):
            d = depth[yy, xx]
            if abs(d) < EPSILON:
                continue
            wx, wy = warp_point(-xi, xx, yy, d, K)
            out[yy, xx] = get_subpixel(gray, wx, wy)
    return out


# ----------------------------------------------------------------- GN (track)

def optimize(
    obj_gray,
    ref_gray,
    ref_depth,
    ref_sigma,
    ref_gx,
    ref_gy,
    xi,
    K,
    level,
    crop=((20, 140), (20, 100)),
):
    """One GN step (optimize.cpp:10-99).  Returns (xi_update, mean_residual,
    valid_pixels) — the reference's Outcome.  Builds the full (N, 6) system
    and solves by lstsq (DECOMP_SVD equivalent).  Weight goes to B only
    (optimize.cpp:87-89)."""
    h, w = ref_gray.shape
    warped = warp_image(xi, ref_gray, ref_depth, K)
    step = {0: 2.0, 1: 1.5}.get(level, 1.0)
    rows_A, rows_B = [], []
    residual = 0.0
    valid = 0
    fx, fy = K[0, 0], K[1, 1]
    for yy in range(h):
        for xx in range(w):
            if level == 2 and (
                xx < crop[0][0] or xx > crop[0][1] or yy < crop[1][0] or yy > crop[1][1]
            ):
                continue
            d = ref_depth[yy, xx]
            if d < 0.20:
                continue
            i1, i2 = obj_gray[yy, xx], warped[yy, xx]
            if not (is_valid(i1) and is_valid(i2)):
                continue
            wx, wy = warp_point(-xi, xx, yy, d, K)
            if wx < 0 or wy < 0 or wx >= w or wy >= h:
                continue
            gx = get_subpixel_from_dense(ref_gx, wx, wy)
            gy = get_subpixel_from_dense(ref_gy, wx, wy)
            if not (is_valid(gx) and is_valid(gy)):
                continue
            valid += 1
            X, Y, Z = back_project(K, xx, yy, d)
            fgx, fgy = fx * gx, fy * gy
            xz, yz = X / Z, Y / Z
            J = np.array(
                [
                    fgx / Z,
                    fgy / Z,
                    -(fgx * X + fgy * Y) / Z / Z,
                    -fgx * xz * yz - fgy * (1 + yz * yz),
                    fgx * (1 + xz * xz) + fgy * xz * yz,
                    -fgx * yz + fgy * xz,
                ]
            )
            r = i2 - i1
            residual += r * r
            sig = np.clip(ref_sigma[yy, xx], 0.01, 0.5)
            rows_A.append(J)
            rows_B.append(r * (step / sig))
    if valid == 0:
        return np.zeros(6), -1.0, 0
    A = np.stack(rows_A)
    B = np.asarray(rows_B)
    x, *_ = np.linalg.lstsq(A, -B, rcond=None)
    return -x, residual / valid, valid


# --------------------------------------------------------------- depth filter

def gaussian_gate(mu, sigma, d, s):
    diff = abs(d - mu)
    m = min(d, diff)
    gain = 0.5 + m / 0.8 * 0.5 if m < 0.8 else 1.0
    return diff <= gain * max(sigma, s)


def gaussian_fuse(mu, sigma, d, s):
    """operator() (gaussian.cpp:33-50): fuse if compatible else keep."""
    if not gaussian_gate(mu, sigma, d, s):
        return mu, sigma, False
    v1, v2 = sigma * sigma, s * s
    v = v1 + v2
    return (v2 * mu + v1 * d) / v, np.sqrt(v1 * v2 / v), True


def regularize(depth, sigma):
    """4-neighbor sequential fusion, order left/right/down/up, clamp <= 6 m
    (implement.cpp:156-180)."""
    h, w = depth.shape
    out = depth.copy()
    for yy in range(h):
        for xx in range(w):
            mu, sg = depth[yy, xx], sigma[yy, xx]
            for dx, dy in ((-1, 0), (1, 0), (0, 1), (0, -1)):
                nx, ny = xx + dx, yy + dy
                if not (0 <= nx < w and 0 <= ny < h):
                    continue
                mu, sg, _ = gaussian_fuse(mu, sg, depth[ny, nx], sigma[ny, nx])
            out[yy, xx] = min(mu, 6.0)
    return out


# -------------------------------------------------------------------- mapping

def epipolar_update(
    obj_gray, ref_gray, ref_gx, ref_gy, relative_xi, K, x_i, depth, sigma,
    luminance_sigma=0.5, epipolar_sigma=0.5, match_ratio=0.1,
):
    """Implement::update (implement.cpp:182-214 + helpers :23-152).
    Returns (new_depth, new_sigma) or (-1, -1)."""
    # EpipolarSegment in the *reference* image under -relative_xi (:23-47)
    dmin = max(depth - sigma, 0.10)
    dmax = depth + sigma
    start = warp_point(-relative_xi, x_i[0], x_i[1], dmax, K)
    end = warp_point(-relative_xi, x_i[0], x_i[1], dmin, K)
    length = float(np.linalg.norm(start - end))
    if length < 1e-12:
        return -1.0, -1.0
    direction = (end - start) / length

    # doMatching (:106-152): 1-px marching, 3-tap center-weighted SSD
    N = 3
    center = (N + 1) // 2
    obj_val = obj_gray[x_i[1], x_i[0]]
    pt = start.copy()
    best = pt.copy()
    min_ssd = 2.0 * N
    count = 0
    while np.linalg.norm(pt - start) < length:
        pt = pt + direction
        ssd = 0.0
        for i in range(N):
            target = pt + (i - N // 2) * direction
            g = get_subpixel_from_dense(ref_gray, target[0], target[1])
            if not is_valid(g):
                ssd = 2.0 * N
                break
            diff = g - obj_val
            ssd += (N - abs(i - center)) / N * diff * diff
        if ssd < min_ssd:
            best = pt.copy()
            min_ssd = ssd
        count += 1
        if count > 100:
            break
    if min_ssd > N * match_ratio:
        return -1.0, -1.0
    if best[0] < 0 or best[1] < 0 or best[0] > obj_gray.shape[1] or best[1] > obj_gray.shape[0]:
        return -1.0, -1.0

    # depthEstimate (:49-71): closed-form two-view triangulation
    x_q = back_project(K, x_i[0], x_i[1], 1.0)
    t = -np.asarray(relative_xi[:3], np.float64)
    R = se3_exp(-np.asarray(relative_xi))[ :3, :3]
    r3 = R[2]
    x_h = np.array([best[0], best[1], 1.0])
    a = (r3 @ x_q) * x_h - K @ (R @ x_q)
    b = t[2] * x_h - K @ t
    denom = a @ a
    new_depth = -(a @ b) / denom if denom > 0 else -1.0

    # sigmaEstimate (:73-104): Engel13 geometric + photometric variances
    l_vec = (start - end) / length
    alpha = (dmax - dmin) / length
    # Mat1f(Point2f) indexing rounds to nearest (cvRound)
    bx, by = int(np.rint(best[0])), int(np.rint(best[1]))
    in_img = 0 <= by < ref_gx.shape[0] and 0 <= bx < ref_gx.shape[1]
    gx = ref_gx[by, bx] if in_img else INVALID
    gy = ref_gy[by, bx] if in_img else INVALID
    if not (is_valid(gx) and is_valid(gy)):
        return new_depth, -1.0
    g_dot_l = abs(gx * l_vec[0] + gy * l_vec[1])
    g_dot_l2 = g_dot_l * g_dot_l
    gp2 = g_dot_l / length
    epi = (epipolar_sigma ** 2) / max(g_dot_l2, EPSILON)
    lum = 2 * (luminance_sigma ** 2) / max(gp2, EPSILON)
    new_sigma = alpha * np.sqrt(epi + lum)
    return new_depth, new_sigma


def propagate(ref_depth, ref_sigma, ref_age, xi, K, predict_sigma=0.06):
    """Forward-warp scatter (implement.cpp:217-256).  Last-writer-wins in
    raster order here (the reference's parallel scatter is racy; the JAX
    path uses deterministic z-buffer min-depth — tests compare only where
    no collision occurs)."""
    tz = xi[2]
    h, w = ref_depth.shape
    depth = np.ones((h, w), np.float32)
    sigma = np.ones((h, w), np.float32)
    age = np.zeros((h, w), np.float32)
    for yy in range(h):
        for xx in range(w):
            rd = ref_depth[yy, xx]
            if abs(rd) < EPSILON:
                continue
            wx, wy = warp_point(xi, xx, yy, rd, K)
            # cv::Point2f -> Point2i conversion rounds to nearest (cvRound)
            ix, iy = int(np.rint(wx)), int(np.rint(wy))
            if not (0 <= ix < w and 0 <= iy < h):
                continue
            s = ref_sigma[yy, xx]
            d0 = max(rd, 0.01)
            d1 = d0 + tz
            s = np.sqrt((d1 / d0) ** 4 * s * s + predict_sigma ** 2)
            depth[iy, ix] = max(d1, 0.0)
            sigma[iy, ix] = s
            age[iy, ix] = ref_age[yy, xx] + 1
    return depth, sigma, age
