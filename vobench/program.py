"""The system under test: ``dvo_tpu_torch``'s entry points as the
benchmark drives them.  This is the one module of the benchmark that
imports the program; the reference (``vobench/reference``) never does.
"""

from __future__ import annotations

import dataclasses

import torch


def dvo_config(config: dict):
    """The program's ``DVOConfig`` preset that ``config`` names, held equal
    field by field to the file's ``dvo`` values (the reference reads those)."""
    from dvo_tpu_torch.config import DVOConfig

    cfg = getattr(DVOConfig, config["preset"])()
    plain = dataclasses.asdict(cfg)
    if _lists(plain) != config["dvo"]:
        raise ValueError(f"{config['name']}: the file's dvo values differ from "
                         f"DVOConfig.{config['preset']}()")
    return cfg


def _lists(x):
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    return x


def mono_init(grays, mask, K, cfg, noise, device):
    """B monocular streams from their first frames ``grays`` (B, H, W):
    one state for B = 1, the stack of B states otherwise."""
    from dvo_tpu_torch.models import odometry

    if grays.shape[0] == 1:
        return odometry.monocular_init(grays[0], mask, K, cfg, device=device, noise=noise[0])
    masks = mask.expand(grays.shape[0], *mask.shape)
    return odometry.monocular_init_batched(grays, masks, K, cfg, device=device, noise=noise)


def mono_chunk(state, grays, mask, K, cfg, resets):
    """One chunk: grays (B, n, H, W) on the device, resets (B, n, h, w)."""
    from dvo_tpu_torch.models import odometry

    if grays.shape[0] == 1:
        return odometry.monocular_run(state, grays[0], mask, K, cfg, reset_depths=resets[0])
    masks = mask.expand(grays.shape[0], *mask.shape)
    return odometry.monocular_run_batched(state, grays, masks, K, cfg, reset_depths=resets)


def rgbd_init(gray, mask, counts, K, cfg, depth_scale, depth_sigma):
    from dvo_tpu_torch.models import odometry

    depth, sigma = odometry.raw_depth(counts, depth_scale, depth_sigma)
    return odometry.rgbd_init(gray, mask, depth, sigma, K, cfg, device=gray.device)


def rgbd_chunk(state, grays, mask, counts, K, cfg, depth_scale, depth_sigma):
    from dvo_tpu_torch.models import odometry

    return odometry.rgbd_run_raw(state, grays, mask, counts, K, cfg, depth_scale, depth_sigma)


def fields(result) -> dict:
    """The per-frame outputs the benchmark drains to the host and judges,
    from a chunk's ``StepResult``."""
    return {"T_world": result.T_world, "rel_xi": result.relative_xi,
            "is_keyframe": result.is_keyframe, "iterations": result.tracking.iterations,
            "valid_counts": result.tracking.valid_counts,
            "residuals": result.tracking.residuals, "observed": result.mapping.observed}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
