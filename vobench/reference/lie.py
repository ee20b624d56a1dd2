"""SE(3) in plain PyTorch for the benchmark's reference step.

Twist xi = [v; w], translation first; ``compose(a, b) = log(exp(a) exp(b))``;
small-angle branches below 1e-6 rad.  The 3x3 and 4x4 products are matrix
products, so they run in TF32 when a caller allows it: that is how the
control (``vobench/control.py``) computes in the precision below float32.
"""

from __future__ import annotations

import torch

SMALL = 1e-6


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _theta(w):
    return torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)


def so3_exp(w):
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = W @ W
    small = th < SMALL
    ths = torch.where(small, 1.0, th)
    a = torch.where(small, 1.0 - th * th / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    return _eye3(W) + a * W + b * W2


def so3_log(R):
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    th = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0))
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < SMALL
    ths = torch.where(small, 1.0, th)
    scale = torch.where(small, 0.5, ths / (2.0 * torch.sin(ths)))[..., None]
    return torch.where(small[..., None], 0.0, scale * vee)


def se3_exp(xi):
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = W @ W
    small = th < SMALL
    ths = torch.where(small, 1.0, th)
    b = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th * th / 120.0, (ths - torch.sin(ths)) / ths ** 3)
    V = _eye3(W) + b * W + c * W2
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def se3_log(T):
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    th = _theta(w)[..., None, None]
    W = hat(w)
    small = th < SMALL
    half = th * 0.5
    cot = torch.where(small, 1.0 / 12.0 + th * th / 720.0,
                      (1.0 - half * torch.cos(half) / torch.where(small, 1.0, torch.sin(half)))
                      / torch.where(small, 1.0, th * th))
    V_inv = _eye3(W) - 0.5 * W + cot * (W @ W)
    return torch.cat([(V_inv @ t[..., None])[..., 0], w], -1)


def compose(a, b):
    return se3_log(se3_exp(a) @ se3_exp(b))


def transform(T, x):
    return (T[..., :3, :3] @ x[..., None])[..., 0] + T[..., :3, 3]
