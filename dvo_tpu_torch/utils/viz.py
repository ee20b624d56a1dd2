"""Debug visualisation — offline PNG dumps replacing the reference's live
OpenCV windows (src/core/draw.cpp): the port's own copy of the numpy part of
``dvo_tpu.utils.viz`` (held equal to it in ``tests/test_torch_utils.py``)
and ``keyframe_gallery`` for the port's ``KeyframeHistory``.

Colourisations mirror the reference:
  * gray: grayscale with invalid pixels red (draw.cpp:7-19);
  * depth: HSV hue from depth (near=red..far=blue) with sigma darkening the
    value channel (draw.cpp:31-67);
  * sigma: hot map; age: discrete colours (draw.cpp:69-100);
  * ``merge``: horizontal tiling of panels (draw.cpp:102-133).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _hsv_to_rgb(h, s, v):
    """Vectorized HSV->RGB, h in [0, 1)."""
    i = np.floor(h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, q, v])
    return np.stack([r, g, b], axis=-1)


def visualize_gray(gray: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(H, W) [0,1] -> (H, W, 3) uint8; invalid pixels red (draw.cpp:7-19)."""
    g = np.clip(np.asarray(gray), 0, 1)
    rgb = np.stack([g, g, g], axis=-1)
    if mask is not None:
        rgb[~np.asarray(mask)] = (1.0, 0.0, 0.0)
    return (rgb * 255).astype(np.uint8)


def visualize_depth(
    depth: np.ndarray,
    sigma: Optional[np.ndarray] = None,
    max_depth: float = 6.0,
) -> np.ndarray:
    """Depth -> hue, sigma -> value (draw.cpp:31-67)."""
    d = np.clip(np.asarray(depth), 0, max_depth) / max_depth
    hue = d * 0.66  # red (near) .. blue (far)
    if sigma is not None:
        v = np.clip(1.0 - np.asarray(sigma), 0.1, 1.0)
    else:
        v = np.ones_like(d)
    rgb = _hsv_to_rgb(hue, np.ones_like(d), v)
    return (rgb * 255).astype(np.uint8)


def visualize_sigma(sigma: np.ndarray, max_sigma: float = 1.0) -> np.ndarray:
    s = np.clip(np.asarray(sigma) / max_sigma, 0, 1)
    rgb = np.stack([s, 1 - s, np.zeros_like(s)], axis=-1)
    return (rgb * 255).astype(np.uint8)


def visualize_age(age: np.ndarray, max_age: int = 8) -> np.ndarray:
    a = np.clip(np.asarray(age).astype(np.float32) / max_age, 0, 0.999)
    rgb = _hsv_to_rgb(a, np.ones_like(a), np.ones_like(a))
    return (rgb * 255).astype(np.uint8)


def visualize_gradient(grad: np.ndarray, scale: float = 2.0) -> np.ndarray:
    g = np.clip(np.asarray(grad) * scale + 0.5, 0, 1)
    return (np.stack([g, g, g], axis=-1) * 255).astype(np.uint8)


def merge(panels: Sequence[np.ndarray], pad: int = 2) -> np.ndarray:
    """Horizontal tile of equal-height RGB panels (draw.cpp:102-133)."""
    h = max(p.shape[0] for p in panels)
    cols = []
    for p in panels:
        if p.shape[0] < h:
            p = np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0)))
        cols.append(p)
        cols.append(np.zeros((h, pad, 3), np.uint8))
    return np.concatenate(cols[:-1], axis=1)


def save_png(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)


def save_panels(path: str, *panels: np.ndarray) -> None:
    save_png(path, merge(panels))


def plot_trajectory(
    poses: np.ndarray,
    path: str,
    gt: Optional[np.ndarray] = None,
    title: str = "trajectory",
) -> None:
    """Offline pose-trail plot — the glfw-drawer equivalent of the
    reference's live trajectory window (main.cpp:49-54 draws the camera
    centers of ``inversePose(T)`` as a 2-D curve).  Writes a PNG with the
    top-down (x, z) path and per-axis position curves.

    ``poses``: (N, 4, 4) camera-to-world; ``gt``: optional (M, 3) ground
    truth positions to overlay."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    poses = np.asarray(poses)
    xyz = poses[:, :3, 3]
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(11, 4.5))
    ax0.plot(xyz[:, 0], xyz[:, 2], "-", lw=1.2, color="tab:blue", label="estimate")
    ax0.plot(xyz[0, 0], xyz[0, 2], "o", color="tab:green", label="start")
    ax0.plot(xyz[-1, 0], xyz[-1, 2], "s", color="tab:red", label="end")
    if gt is not None:
        gt = np.asarray(gt)
        ax0.plot(gt[:, 0], gt[:, 2], "--", lw=1.0, color="gray", label="ground truth")
    ax0.set_xlabel("x [m]")
    ax0.set_ylabel("z [m]")
    ax0.set_title(f"{title} — top-down")
    ax0.axis("equal")
    ax0.legend(fontsize=8)
    for i, name in enumerate("xyz"):
        ax1.plot(xyz[:, i], lw=1.0, label=name)
    ax1.set_xlabel("frame")
    ax1.set_ylabel("position [m]")
    ax1.set_title("per-axis position")
    ax1.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def keyframe_gallery(history) -> np.ndarray:
    """The ring's live slots, newest first — the reference's SHOW_KEYFRAME
    panel (system.hpp:7,34-42) as an image.  Each row: gray | depth(sigma)
    | sigma of one keyframe.  One host copy of each plane stack."""
    from dvo_tpu_torch.models.history import host_ints

    head, count = host_ints(history)
    cap = history.capacity
    gray, mask, depth, sigma = (t.detach().cpu().numpy() for t in
                                (history.gray, history.mask, history.depth, history.sigma))
    rows = []
    for age in range(count):
        slot = (head - age) % cap
        rows.append(merge([
            visualize_gray(gray[slot], mask[slot]),
            visualize_depth(depth[slot], sigma[slot]),
            visualize_sigma(sigma[slot]),
        ]))
    if not rows:
        return np.zeros((1, 1, 3), np.uint8)
    out = []
    for r in rows:   # one ring: every row has the same width
        out.append(r)
        out.append(np.zeros((2, r.shape[1], 3), np.uint8))
    return np.concatenate(out[:-1], axis=0)
