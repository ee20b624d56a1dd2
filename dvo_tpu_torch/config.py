"""Configuration for the PyTorch port — every constant of the reference, as
a named field.

The dataclasses have the fields, defaults and presets of ``dvo_tpu.config``
(held equal field by field in ``tests/test_torch_config.py``); the port
keeps its own copy and imports nothing of that package.  The reference
source is cited beside each default.  ``compat_*`` flags select
faithful-vs-fixed behaviour for the reference's quirks.

Fields that exist only for the JAX package's TPU kernels stay, so that a
configuration converts either way, and are ignored here:
``TrackerConfig.backend``/``pallas_precision``/``gather_window``/
``early_exit`` and ``MapperConfig.backend``/``pallas_precision``/
``gather_window``/``gather_slots``.  The port always samples in float32 over
the full image and the full keyframe ring, and its GN loop always stops at
convergence with the results of the fixed-length masked loop (on a CUDA
card inside one kernel launch per level, with no host sync).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = [
    "EPSILON",
    "INVALID",
    "BAConfig",
    "DepthFilterConfig",
    "DVOConfig",
    "InitConfig",
    "MapperConfig",
    "PyramidConfig",
    "TrackerConfig",
    "config_from_reference",
    "resolve_device",
]


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Image pyramid shape (include/system/system.hpp:30,47,82).

    ``levels`` pyramid scenes are built coarsest-first; the input is first
    decimated by ``2**culls`` (include/system/frame.hpp:99-117,
    src/system/frame.cpp:30-37)."""

    levels: int = 3          # monocular mode (system.hpp:47); RGB-D uses 4
    culls: int = 2           # monocular mode (system.hpp:47); RGB-D uses 1


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Coarse-to-fine photometric Gauss-Newton tracking
    (src/track/tracker.cpp:16-19, src/track/optimize.cpp)."""

    max_iterations: int = 15          # tracker.cpp:19 MAXIMUM_ITERATION
    min_update_norm: float = 5e-4     # tracker.cpp:17 MINIMUM_UPDATE
    min_residual: float = 5e-3        # tracker.cpp:16 MINIMUM_RESIDUAL
    # The reference also aborts past a 200 ms wall-clock budget
    # (tracker.cpp:18,68-73); a device program cannot branch on host time,
    # so the loop is bounded by max_iterations alone.
    min_depth: float = 0.20           # optimize.cpp:39 depth gate [m]
    # Per-level weight numerator ("step"): level 0 -> 2.0, 1 -> 1.5, 2+ -> 1.0
    # (optimize.cpp:22-26).
    level_steps: Tuple[float, ...] = (2.0, 1.5, 1.0, 1.0)
    sigma_clamp: Tuple[float, float] = (0.01, 0.5)  # optimize.cpp:83
    # Level-2 crop: keep x in [20, 140], y in [20, 100] inclusive
    # (optimize.cpp:33-36 — absolute pixels, hard-coded for 160x120 but the
    # reference applies them verbatim at level index 2 of *any* pyramid).
    crop_level: int = 2               # level index the crop applies to
    crop_x: Tuple[int, int] = (20, 140)
    crop_y: Tuple[int, int] = (20, 100)
    # Faithful: weight applied to the residual vector B only, not to the
    # Jacobian rows A (optimize.cpp:87-89), which scales every GN update by
    # the sigma-dependent weight.  Default is the weighted normal equations
    # (weight on both sides).  Set True only for single-step parity tests
    # against the reference.
    compat_weight_b_only: bool = False
    # Levenberg damping added to the diagonal of J^T J (the reference's
    # DECOMP_SVD pseudo-inverse is emulated by a tiny ridge).
    damping: float = 1e-6
    # Constant-velocity warm start (the reference always starts GN from
    # identity, tracker.cpp:28): seed each frame's optimisation with the
    # previous relative pose composed with the last frame-to-frame velocity.
    # The prior is dropped (identity start) when its norm exceeds
    # ``warm_start_max_norm``.  Off by default: in the noise-bootstrap
    # monocular mode the early poses are driven by depth noise and a
    # velocity prior built from them slows the depth field's convergence.
    # The RGB-D preset turns it on.
    warm_start: bool = False
    warm_start_max_norm: float = 0.5
    # JAX package only: while_loop (True) or masked scan (False) loop.
    early_exit: bool = True
    # JAX package only: GN linearisation backend ("auto", "xla", "pallas").
    backend: str = "auto"
    # JAX package only: matmul mode of the Pallas kernel's sampling.
    pallas_precision: str = "high"
    # JAX package only: rows gathered per block by the Pallas kernel.
    gather_window: int = 32


@dataclasses.dataclass(frozen=True)
class DepthFilterConfig:
    """Gaussian inverse-variance depth fusion (src/math/gaussian.cpp)."""

    # Compatibility gate: reject an observation if |d - mu| > gain * max(sigma, s)
    # where gain ramps 0.5 -> 1.0 over 0.8 m of min(d, |d - mu|)
    # (gaussian.cpp:19-21).
    gain_ramp: float = 0.8
    # On rejection in update(): reset depth to a uniform random draw capped at
    # 4.0 m and sigma to 0.5 (gaussian.cpp:22-25).  The reference constructs
    # uniform_real_distribution(2.0, 0.5) with reversed bounds; the draw here
    # is from [0.5, 2.0], the evident intent.
    reset_depth_range: Tuple[float, float] = (0.5, 2.0)
    reset_depth_cap: float = 4.0
    reset_sigma: float = 0.5


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Keyframe policy and epipolar depth update
    (src/map/mapper.cpp:12-13,90,122; src/map/implement.cpp:12-20)."""

    min_movement: float = 0.02        # mapper.cpp:12 MINIMUM_MOVEMENT [m]
    max_forward: int = 6              # mapper.cpp:13 MAXIMUM_FORWARD [frames]
    # Depth-update crop: keep x in [16, 144], y in [12, 108] inclusive
    # (mapper.cpp:90, absolute pixels).
    crop_x: Tuple[int, int] = (16, 144)
    crop_y: Tuple[int, int] = (12, 108)
    # Epipolar search (implement.cpp)
    luminance_sigma: float = 0.5      # implement.cpp:12
    epipolar_sigma: float = 0.5       # implement.cpp:14
    predict_sigma: float = 0.06       # implement.cpp:17 [m]
    matching_threshold_ratio: float = 0.1   # implement.cpp:20
    ssd_window: int = 3               # implement.cpp:118 N
    max_steps: int = 100              # implement.cpp:141 step cap
    min_search_depth: float = 0.10    # implement.cpp:30 max(depth - sigma, 0.10)
    # Observation acceptance gates (mapper.cpp:122)
    accept_depth: Tuple[float, float] = (0.2, 6.0)
    accept_sigma: Tuple[float, float] = (0.0, 0.5)
    # Regularizer clamps fused depth to <= 6 m (implement.cpp:178).
    max_depth: float = 6.0
    # Keyframe ring-buffer capacity (the reference grows its history without
    # bound, frame.hpp:146-188; a fixed ring keeps shapes static).
    history_capacity: int = 8
    depth_filter: DepthFilterConfig = dataclasses.field(default_factory=DepthFilterConfig)
    # JAX package only: mapping backend ("auto", "xla", "pallas").
    backend: str = "auto"
    # JAX package only: matmul precision inside the Pallas march kernel.
    pallas_precision: str = "bf16"
    # JAX package only: rows gathered per row block by the Pallas march.
    gather_window: int = 48
    # JAX package only: keyframe-ring slots the Pallas march gathers from.
    gather_slots: int = 0


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Monocular depth bootstrap (include/system/frame.hpp:12-22)."""

    depth_mean: float = 1.5
    depth_std: float = 0.5
    depth_floor: float = 0.5
    sigma: float = 0.5
    # Propagate initialises unobserved destination pixels to depth=1, sigma=1
    # (implement.cpp:229-231).
    propagate_depth: float = 1.0
    propagate_sigma: float = 1.0


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Windowed photometric bundle adjustment on keyframe promotion
    (``models/ba``; no reference counterpart)."""

    enabled: bool = False
    window: int = 7                   # keyframes per BA window
    iterations: int = 5               # Levenberg-Marquardt outer iterations
    damping: float = 1e-4
    huber_delta: float = 0.1          # photometric robust loss threshold
    depth_damping: float = 1e-3       # ridge on the (diagonal) depth block


@dataclasses.dataclass(frozen=True)
class DVOConfig:
    """Top-level configuration."""

    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)

    @staticmethod
    def monocular() -> "DVOConfig":
        """Monocular mode: 3 levels, input pre-decimated 4x (system.hpp:47).
        ``gather_slots=4`` is the JAX package's preset and ignored here."""
        return DVOConfig(
            pyramid=PyramidConfig(levels=3, culls=2),
            mapper=MapperConfig(gather_slots=4),
        )

    @staticmethod
    def monocular_ba() -> "DVOConfig":
        """``monocular()`` with windowed photometric BA on every promotion
        whose window is full (``BAConfig`` defaults: 7 keyframes, 5
        iterations), the back end of Direct Sparse Odometry's windowed
        optimisation (Engel, Koltun, Cremers, TPAMI 2018, section 3) on this
        front end."""
        return dataclasses.replace(DVOConfig.monocular(), ba=BAConfig(enabled=True))

    @staticmethod
    def rgbd() -> "DVOConfig":
        """RGB-D tracking mode: 4 levels, 2x decimation (system.hpp:30,82).

        Warm start on: frame-to-frame tracking on measured depth is coherent,
        so the constant-velocity prior cuts the executed GN iterations.

        ``min_update_norm`` raised to 1.5e-3 (reference default 5e-4,
        tracker.cpp:16, tuned for its 160x120 mono mode): on 512x424 Kinect
        frames the GN updates contract by only ~0.9 per iteration, so the
        reference threshold never fires within the 15-iteration cap; at
        1.5e-3 tracking stops 5-8 iterations earlier per level inside the
        known-motion rigs' accuracy bands.  ``pallas_precision`` is the JAX
        package's preset and ignored here."""
        return DVOConfig(
            pyramid=PyramidConfig(levels=4, culls=1),
            tracker=TrackerConfig(warm_start=True, min_update_norm=1.5e-3,
                                  pallas_precision="bf16"),
        )


# Invalid-pixel sentinel used at the host/IO boundary only (undistortion
# border fill, reference math/util.hpp:7).  On the device validity is an
# explicit boolean mask, never a magic value.
INVALID = -2.0
EPSILON = 1e-6


def _from_plain(cls, values: dict):
    """``cls`` from ``dataclasses.asdict`` output: nested dataclass fields
    are rebuilt from their dicts, tuples from the lists or tuples given."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = values[f.name]
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING \
            else f.default
        if dataclasses.is_dataclass(default):
            value = _from_plain(type(default), value)
        elif isinstance(default, tuple):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def config_from_reference(cfg):
    """The port's configuration with the values of ``cfg``, a ``dvo_tpu``
    configuration dataclass of any of the classes above (taken as a plain
    object through ``dataclasses.asdict``; this module imports nothing of
    ``dvo_tpu``).  The class is matched by name, the fields must be the
    same."""
    cls = globals().get(type(cfg).__name__)
    if not (dataclasses.is_dataclass(cfg) and isinstance(cls, type)
            and dataclasses.is_dataclass(cls)):
        raise TypeError(f"not a configuration dataclass: {type(cfg).__name__}")
    values = dataclasses.asdict(cfg)
    names = {f.name for f in dataclasses.fields(cls)}
    if set(values) != names:
        raise ValueError(f"{cls.__name__}: fields differ: {sorted(set(values) ^ names)}")
    return _from_plain(cls, values)


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
