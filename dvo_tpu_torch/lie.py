"""Batched SE(3)/SO(3) Lie algebra in PyTorch — ``dvo_tpu.lie`` ported.

Same conventions as the JAX package (and the reference se3.cpp): twist
xi = [v; w] with translation first, ``compose(a, b) = log(exp(a) exp(b))``.
Every small-angle branch is a ``torch.where`` over guarded denominators, so
no function reads a tensor value on the host; all accept arbitrary leading
batch dimensions.

The chain differentiates as ``dvo_tpu.lie`` does (the pose graph takes the
Jacobian of ``se3_log`` of a product of ``se3_exp``s, in forward or reverse
mode): the operand of every untaken ``where`` branch is replaced by a safe
one, so no branch feeds an infinite or NaN derivative into the selected
one, and ``so3_log``'s zero value below the threshold keeps the derivative
of the exact branch.
"""

from __future__ import annotations

import torch

_SMALL = 1e-6  # reference small-angle threshold (se3.cpp:84,113)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix (se3.cpp:8-15)."""
    zeros = torch.zeros_like(w[..., 0])
    rows = [
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _theta(w: torch.Tensor) -> torch.Tensor:
    """Rotation angle, (..., 3) -> (...); the floor keeps the square root's
    derivative finite at w = 0."""
    return torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3), with second-order
    Taylor branches below the threshold."""
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = W @ W
    small = th < _SMALL
    ths = torch.where(small, 1.0, th)
    a = torch.where(small, 1.0 - th * th / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    return _eye3(W) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3).  Below 1e-6 rad the value is exactly zero,
    as in the reference and ``dvo_tpu.lie.so3_log``, and the derivative is
    that of the exact branch, ``0.5 * vee`` (``x - x.detach()`` is 0 with
    the derivative of x): a constant zero there would give the pose graph a
    zero rotation block at every exactly consistent edge."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_th = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0)
    th = torch.arccos(cos_th)
    vee = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    small = th < _SMALL
    # arccos has an infinite derivative at cos = 1 (the identity), and
    # reverse mode multiplies it by the where's zero: the angle that the
    # exact branch differentiates is taken at a cosine moved off 1 wherever
    # that branch is not selected.  Its value where selected is th's.
    ths = torch.where(small, 1.0, torch.arccos(torch.where(small, 0.0, cos_th)))
    scale = torch.where(small, 0.5, ths / (2.0 * torch.sin(ths)))[..., None]
    out = scale * vee
    return torch.where(small[..., None], out - out.detach(), out)


def _v_coeffs(w: torch.Tensor):
    """(W, W2, b, c) with b = (1-cos)/th^2, c = (th-sin)/th^3."""
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = W @ W
    small = th < _SMALL
    ths = torch.where(small, 1.0, th)
    b = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    c = torch.where(small, 1.0 / 6.0 - th * th / 120.0, (ths - torch.sin(ths)) / (ths ** 3))
    return W, W2, b, c


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4): R = so3_exp(w), t = V v."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    W, W2, b, c = _v_coeffs(w)
    V = _eye3(W) + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # fill_, not `= 1.0`: a scalar store syncs on CUDA
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) with
    V^-1 = I - W/2 + (1 - th cos(th/2) / (2 sin(th/2))) / th^2 W^2."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    th = _theta(w)[..., None, None]
    W = hat(w)
    W2 = W @ W
    small = th < _SMALL
    half = th * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + th * th / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, 1.0, torch.sin(half)))
        / torch.where(small, 1.0, th * th),
    )
    V_inv = _eye3(W) - 0.5 * W + cot_term * W2
    v = (V_inv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def compose(xi0: torch.Tensor, xi1: torch.Tensor) -> torch.Tensor:
    """log(exp(xi0) @ exp(xi1)) (reference ``concatenate``, se3.cpp:127-131)."""
    return se3_log(se3_exp(xi0) @ se3_exp(xi1))


def inverse(xi: torch.Tensor) -> torch.Tensor:
    """Twist of the inverse transform: -xi (exp(-xi) = exp(xi)^-1)."""
    return -xi


def transform(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3): R x + t."""
    return (T[..., :3, :3] @ x[..., None])[..., 0] + T[..., :3, 3]


def invert_T(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse [R^T | -R^T t] of (..., 4, 4) transforms (the
    reference's ``inversePose``, convert.cpp:31-39, omits the rotation of t
    and is used only for display)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:])[..., 0]
    out[..., 3, 3].fill_(1.0)
    return out


def is_finite_xi(xi: torch.Tensor) -> torch.Tensor:
    """NaN/Inf guard on a twist, (..., 6) -> (...) bool (util.hpp:34-44)."""
    return torch.all(torch.isfinite(xi), dim=-1)
