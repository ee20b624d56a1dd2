"""Synthetic camera rigs: the benchmark's frames, made on the device.

A scene of textured planes (a back wall, a box's front, a floor, a slanted
wall) in world coordinates (x right, y down, z forward) is rendered by
ray-plane intersection from a camera that moves along a smooth closed
path: it returns to its start after ``period`` frames, so a window replays
the frames cyclically with no jump and never leaves the scene.  The
per-frame motion is about ``step`` metres.  Every view is consistent with
every other (the texture is defined in 3D), as a real sequence is.

The scene (its depths and texture) is scene number ``scene``, the same for
every seed: the work a frame costs depends on what it shows (GN steps,
observations), so every seed gives the same set of frames.  The seed
draws where on the path the cycle starts and the sensor's noise and holes.

``render`` returns uint8 gray (and for RGB-D uint16 depth counts with
sensor noise and holes) on the device; the harness moves them into pinned
host memory, where a camera or a decoder would hand them over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WAVES = 10          # 3D sinusoids of the texture


def _scene(rng: np.random.Generator):
    """The planes (normal, offset, optional (x, y) bounds) of one scene,
    drawn from ``rng`` around a room of about 1-2 m."""
    back = rng.uniform(1.5, 1.8)
    box = rng.uniform(0.85, 1.0)
    bx = rng.uniform(-0.4, -0.2)
    floor = rng.uniform(0.4, 0.5)
    tilt = rng.uniform(0.25, 0.35)
    n = np.array([1.0, 0.0, -tilt])
    n /= np.linalg.norm(n)
    return (((0.0, 0.0, 1.0), back, None),
            ((0.0, 0.0, 1.0), box, ((bx, bx + 0.4), (-0.3, 0.25))),
            ((0.0, 1.0, 0.0), floor, None),
            (tuple(n), 0.35 * n[0], None))


def _path(k: torch.Tensor, period: int, step: float):
    """Camera centre (..., 3) and yaw (...) of frame ``k`` on a closed loop
    whose length is ``period * step``: a circle in x and z with a little
    rise and yaw, float64."""
    phi = 2.0 * math.pi * k / period
    r = period * step / (2.0 * math.pi)
    c = torch.stack([r * torch.sin(phi), -0.2 * r * (1.0 - torch.cos(phi)),
                     0.4 * r * (1.0 - torch.cos(phi))], -1)
    return c, 0.03 * torch.sin(phi)


def render(shape, K, period: int, step: float, scene: int, seed: int, device,
           depth_scale: float = 0.0, noise: float = 0.0, holes: float = 0.0):
    """``period`` views of scene ``scene`` at ``shape`` = (h, w) through the
    pinhole ``K`` (3x3 list), from the path position that ``seed`` draws
    on.  Returns (gray uint8 (period, h, w), counts uint16 (period, h, w)
    or None) on ``device``: counts are the depth (z) times ``depth_scale``
    when that is positive, with ``holes`` of the pixels at 0; ``noise`` is
    the gray's standard deviation before rounding, drawn from ``seed``."""
    h, w = shape
    rng = np.random.default_rng(scene)
    planes = _scene(rng)
    dirs = rng.normal(size=(WAVES, 3))
    freqs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True) * rng.uniform(50, 140, (WAVES, 1))
    phases = rng.uniform(0.0, 2.0 * math.pi, WAVES)
    amps = rng.uniform(0.5, 1.0, WAVES)
    f64 = dict(dtype=torch.float64, device=device)
    freqs, phases, amps = (torch.tensor(x, **f64) for x in (freqs, phases, amps))
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    (fx, _, cx), (_, fy, cy), _ = K
    ys, xs = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    rays = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)]).reshape(3, -1)
    grays = torch.empty((period, h, w), dtype=torch.uint8, device=device)
    counts = torch.empty((period, h, w), dtype=torch.int32, device=device) if depth_scale > 0 \
        else None
    phase = int(np.random.default_rng(seed).integers(period))
    centres, yaws = _path(torch.arange(phase, phase + period, **f64), period, step)
    for k in range(period):
        c, yaw = centres[k], yaws[k]
        cs, sn = torch.cos(yaw), torch.sin(yaw)
        # world-to-camera rotation about y; a ray's world direction is R^T ray
        R = torch.stack([torch.stack([cs, yaw * 0, -sn]), torch.tensor([0.0, 1.0, 0.0], **f64),
                         torch.stack([sn, yaw * 0, cs])])
        dw = R.T @ rays
        best = torch.full((h * w,), math.inf, **f64)
        for normal, offset, bounds in planes:
            nrm = torch.tensor(normal, **f64)
            nd = nrm @ dw
            s = (offset - nrm @ c) / torch.where(nd.abs() < 1e-12, 1e-12, nd)
            ok = s > 1e-6
            if bounds is not None:
                P = c[:, None] + s * dw
                (x0, x1), (y0, y1) = bounds
                ok = ok & (P[0] >= x0) & (P[0] <= x1) & (P[1] >= y0) & (P[1] <= y1)
            best = torch.where(ok & (s < best), s, best)
        hit = torch.isfinite(best)
        P = c[:, None] + torch.where(hit, best, 1.0) * dw
        tex = (amps[:, None] * torch.sin(freqs @ P + phases[:, None])).sum(0)
        gray = torch.where(hit, 0.5 + 0.5 * torch.tanh(1.5 * tex), 0.0).reshape(h, w)
        if noise > 0:
            gray = gray + noise * torch.randn((h, w), generator=gen, **f64)
        grays[k] = torch.clamp(torch.round(gray * 255.0), 0, 255).to(torch.uint8)
        if counts is not None:
            # the ray's z is 1 in the camera, so its parameter is the depth
            z = torch.where(hit, best, 0.0).reshape(h, w)
            c16 = torch.clamp(torch.round(z * depth_scale), 0, 65535).to(torch.int32)
            drop = torch.rand((h, w), generator=gen, **f64) < holes
            counts[k] = torch.where(drop, 0, c16)
    return grays, (None if counts is None else counts.to(torch.uint16))
