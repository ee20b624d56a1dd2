"""Configuration for the PyTorch port.

The dataclasses are ``dvo_tpu.config``'s own (plain dataclasses; that module
imports ``jax`` only inside ``resolve_backend``, which the port never calls).
Fields that exist only for the TPU kernels are ignored here:
``TrackerConfig.backend``/``pallas_precision``/``gather_window``/
``early_exit`` and ``MapperConfig.backend``/``pallas_precision``/
``gather_window``/``gather_slots``.  The port always samples in float32 over
the full image and the full keyframe ring, and always runs the fixed-length
masked GN driver (no per-iteration host sync).
"""

from __future__ import annotations

import torch

from dvo_tpu.config import (
    EPSILON,
    BAConfig,
    DepthFilterConfig,
    DVOConfig,
    InitConfig,
    MapperConfig,
    PyramidConfig,
    TrackerConfig,
)

__all__ = [
    "EPSILON",
    "BAConfig",
    "DepthFilterConfig",
    "DVOConfig",
    "InitConfig",
    "MapperConfig",
    "PyramidConfig",
    "TrackerConfig",
    "resolve_device",
]


def resolve_device(device) -> str:
    """Which implementation a kernel wrapper runs for ``device`` (a tensor,
    ``torch.device`` or device string): ``"cuda"`` — the hand-written
    kernel — for a CUDA device, ``"plain"`` — the PyTorch version — for the
    CPU.  Any other device raises: there is no silent fallback."""
    if isinstance(device, torch.Tensor):
        device = device.device
    kind = torch.device(device).type
    if kind == "cuda":
        return "cuda"
    if kind == "cpu":
        return "plain"
    raise ValueError(f"no dvo_tpu_torch implementation for device {device!r}")
