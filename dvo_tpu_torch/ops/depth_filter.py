"""Gaussian inverse-variance depth filter — ``dvo_tpu.ops.depth_filter``
ported (reference gaussian.cpp).

The reset draw of ``gaussian_update_with_reset`` is an input plane here,
not a PRNG key: callers draw it (``draw_reset_depth``) or pass the plane a
reference run drew, so both packages can be fed the same numbers.
"""

from __future__ import annotations

import torch

from dvo_tpu_torch.config import DepthFilterConfig


def _gate(mu, sigma, d, s, cfg: DepthFilterConfig):
    diff = torch.abs(d - mu)
    m = torch.minimum(d, diff)
    gain = torch.where(m < cfg.gain_ramp, 0.5 + m / cfg.gain_ramp * 0.5, 1.0)
    return diff <= gain * torch.maximum(sigma, s)


def _fuse(mu, sigma, d, s):
    v1 = sigma * sigma
    v2 = s * s
    v = v1 + v2
    safe_v = torch.where(v < 1e-12, 1.0, v)
    return (v2 * mu + v1 * d) / safe_v, torch.sqrt(v1 * v2 / safe_v)


def gaussian_fuse(mu, sigma, d, s, obs_valid, cfg: DepthFilterConfig = DepthFilterConfig()):
    """Fuse valid, compatible observations, else keep the prior
    (gaussian.cpp:33-50).  Returns (mu', sigma', accepted)."""
    ok = _gate(mu, sigma, d, s, cfg) & obs_valid
    mu_new, sigma_new = _fuse(mu, sigma, d, s)
    return torch.where(ok, mu_new, mu), torch.where(ok, sigma_new, sigma), ok


def draw_reset_depth(shape, cfg: DepthFilterConfig, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """min(U(lo, hi), cap): the reset prior of gaussian.cpp:22-25."""
    lo, hi = cfg.reset_depth_range
    u = torch.rand(shape, generator=generator, device=device)
    return torch.clamp(lo + (hi - lo) * u, max=cfg.reset_depth_cap)


def gaussian_update_with_reset(mu, sigma, d, s, reset_depth, obs_valid,
                               cfg: DepthFilterConfig = DepthFilterConfig()):
    """Fuse where compatible; where an observation is rejected, reset the
    pixel to ``reset_depth`` and sigma to ``cfg.reset_sigma``.  Pixels with
    invalid observations are left untouched.  Returns (mu', sigma', accepted)."""
    gate = _gate(mu, sigma, d, s, cfg)
    ok = gate & obs_valid
    rejected = ~gate & obs_valid
    mu_new, sigma_new = _fuse(mu, sigma, d, s)
    mu_out = torch.where(ok, mu_new, torch.where(rejected, reset_depth, mu))
    sigma_out = torch.where(ok, sigma_new, torch.where(rejected, cfg.reset_sigma, sigma))
    return mu_out, sigma_out, ok
