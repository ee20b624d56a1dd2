"""Scene and Frame — ``dvo_tpu.models.frame`` ported to dataclasses of
tensors.

Pyramid convention as in the JAX package (reference frame.cpp:30-37):
scenes are coarsest first; ``scenes[-1]`` is the base level, the input
decimated by ``2**culls``.  Functions return new dataclasses and never
write into a tensor they were given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dvo_tpu_torch import lie
from dvo_tpu_torch.config import InitConfig, MapperConfig, resolve_device
from dvo_tpu_torch.ops.cuda.framebuild import (
    build_pyramid_planes,
    cull_pyramid_one,
    cull_pyramid_pair,
    regularize_cull_pyramid,
)
from dvo_tpu_torch.ops.cuda.regularize import regularize
from dvo_tpu_torch.ops.image import cull_image, cull_intrinsic, gradients


@dataclasses.dataclass(frozen=True)
class Scene:
    """One pyramid level.  ``depth``/``sigma`` are None on a step's object
    frame until promotion gives it a depth map; on the CPU ``gx``/``gy``/
    ``gmask`` are None there until ``with_gradients`` (only the reference
    keyframe's gradients are ever read).  On CUDA the planes are views into
    one buffer per plane kind (``ops/cuda/framebuild``)."""

    gray: torch.Tensor                      # (H, W) float32 in [0, 1]
    mask: torch.Tensor                      # (H, W) bool
    depth: Optional[torch.Tensor]           # (H, W) float32 [m]
    sigma: Optional[torch.Tensor]           # (H, W) float32 [m]
    gx: Optional[torch.Tensor]              # (H, W) central difference, not halved
    gy: Optional[torch.Tensor]
    gmask: Optional[torch.Tensor]           # (H, W) bool
    K: torch.Tensor                         # (3, 3)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.gray.shape)


def device_int(value, device) -> torch.Tensor:
    """``value`` (a Python or NumPy int) as a 0-d int32 tensor on
    ``device``; a tensor passes through as int32 on ``device`` with its
    shape (a stack of B streams holds one id per stream).  A Python int
    becomes a fill on the device, not a host-to-device copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32)
    return torch.full((), int(value), dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Frame:
    """Pyramid + pose (reference frame.hpp:72-144).  ``frame_id`` is a 0-d
    int32 tensor on the frame's device, as in ``dvo_tpu`` (a Python int is
    converted): the monocular step's keyframe decision reads it there."""

    scenes: Tuple[Scene, ...]   # coarsest first
    xi: torch.Tensor            # (6,) world pose twist
    relative_xi: torch.Tensor   # (6,) twist vs the reference keyframe
    age: torch.Tensor           # (H, W) int32 at the base level
    frame_id: torch.Tensor      # () int32

    def __post_init__(self):
        object.__setattr__(self, "frame_id", device_int(self.frame_id, self.xi.device))

    @property
    def base(self) -> Scene:
        return self.scenes[-1]

    @property
    def levels(self) -> int:
        return len(self.scenes)


def _pyramid(gray, mask, depth, sigma, K, levels: int, with_grads: bool):
    """Coarsest-first pyramid, every level re-culled from the base.

    On CUDA the whole pyramid is one ``csrc/framebuild.cu`` launch, which
    emits every level's gradients whatever ``with_grads`` says, as
    ``dvo_tpu``'s fused build does (its ``frame.py:106-137``);
    ``with_gradients`` then passes through.  On the CPU the plain build
    defers them when ``with_grads`` is False.  The planes are equal either
    way."""
    if with_grads or resolve_device(gray) == "cuda":
        planes = build_pyramid_planes(gray, mask, depth, sigma, levels)
    else:
        planes = [dict(gray=cull_image(gray, t), mask=cull_image(mask, t),
                       depth=None if depth is None else cull_image(depth, t),
                       sigma=None if sigma is None else cull_image(sigma, t),
                       gx=None, gy=None, gmask=None)
                  for t in range(levels - 1, -1, -1)]
    return tuple(Scene(K=cull_intrinsic(K, levels - 1 - i), **p)
                 for i, p in enumerate(planes))


def normalize_gray(gray: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float input passes through."""
    if gray.dtype == torch.uint8:
        return gray.to(torch.float32) * (1.0 / 255.0)
    return gray


def _frame(gray, mask, K, levels, frame_id, depth, sigma, with_grads) -> Frame:
    h, w = gray.shape
    dev = gray.device
    return Frame(
        scenes=_pyramid(gray, mask, depth, sigma, K, levels, with_grads),
        xi=torch.zeros(6, dtype=torch.float32, device=dev),
        relative_xi=torch.zeros(6, dtype=torch.float32, device=dev),
        age=torch.zeros((h, w), dtype=torch.int32, device=dev),
        frame_id=frame_id,
    )


def build_frame(gray, mask, K, levels: int, culls: int, frame_id,
                init: InitConfig = InitConfig(),
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Frame:
    """Monocular frame with the noise bootstrap depth
    max(mean + std * n, floor), sigma = init.sigma (frame.hpp:12-22).
    ``n`` is ``noise`` (a standard-normal plane at the culled size) when
    given, else drawn from ``generator``."""
    gray = cull_image(normalize_gray(gray), culls)
    mask = cull_image(mask, culls)
    K = cull_intrinsic(K, culls)
    h, w = gray.shape
    if noise is None:
        noise = torch.randn((h, w), generator=generator, device=gray.device)
    depth = torch.clamp(init.depth_mean + init.depth_std * noise, min=init.depth_floor)
    sigma = torch.full((h, w), init.sigma, dtype=torch.float32, device=gray.device)
    return _frame(gray, mask, K, levels, frame_id, depth, sigma, with_grads=True)


def build_tracking_frame(gray, mask, K, levels: int, culls: int, frame_id) -> Frame:
    """A step's object frame: no depth and deferred gradients.  Its
    bootstrap depth would be dead — promotion overwrites it with
    ``propagate``'s output and nothing else reads it — so none is drawn."""
    gray = cull_image(normalize_gray(gray), culls)
    return _frame(gray, cull_image(mask, culls), cull_intrinsic(K, culls), levels,
                  frame_id, None, None, with_grads=False)


def build_frame_with_depth(gray, mask, depth, sigma, K, levels: int, culls: int,
                           frame_id) -> Frame:
    """RGB-D frame with measured depth and sigma (frame.hpp:91-106);
    ``gray`` may be uint8."""
    gray = cull_image(normalize_gray(gray), culls)
    return _frame(gray, cull_image(mask, culls), cull_intrinsic(K, culls), levels, frame_id,
                  cull_image(depth, culls), cull_image(sigma, culls), with_grads=True)


def with_gradients(frame: Frame) -> Frame:
    """Fill in deferred gradient planes; scenes that have them pass through."""
    scenes = []
    for s in frame.scenes:
        if s.gx is None:
            gx, gy, mx, my = gradients(s.gray, s.mask)
            s = dataclasses.replace(s, gx=gx, gy=gy, gmask=mx & my)
        scenes.append(s)
    return dataclasses.replace(frame, scenes=tuple(scenes))


def _one_buffer(views) -> Optional[torch.Tensor]:
    """The 1-D buffer that per-level planes are back-to-back views of (the
    frame-build kernel's layout, ``ops/cuda/framebuild``), or None when they
    are not: separate tensors (the plain build, a loaded state)."""
    first = views[0]
    ptr, end = first.untyped_storage().data_ptr(), first.storage_offset()
    for v in views:
        if not v.is_contiguous() or v.untyped_storage().data_ptr() != ptr \
                or v.storage_offset() != end:
            return None
        end += v.numel()
    return first.as_strided((end - first.storage_offset(),), (1,))


def _select_planes(flag, a_views, b_views):
    """Per-level ``where(flag, a, b)`` of two pyramids of one shape: one
    ``torch.where`` over the buffers when both lie back to back in one (the
    card's frames), then the same per-level views of the result; else one
    per level."""
    a_buf, b_buf = _one_buffer(a_views), _one_buffer(b_views)
    if a_buf is None or b_buf is None:
        return [torch.where(flag, a, b) for a, b in zip(a_views, b_views)]
    out, off = torch.where(flag, a_buf, b_buf), 0
    views = []
    for v in a_views:
        views.append(out[off:off + v.numel()].view(v.shape))
        off += v.numel()
    return views


def select_frame(flag: torch.Tensor, a: Frame, b: Frame) -> Frame:
    """``a`` where the device bool ``flag`` holds, else ``b``, with no host
    read: the gray, mask and gradient planes of every level, ``K``, the
    poses, ``age`` and ``frame_id``.  Depth and sigma are selected where both
    frames have them and are None otherwise (the monocular step replaces
    them right after).  Both frames need the same pyramid shape and their
    gradients (``with_gradients``)."""
    planes = {}
    for name in ("gray", "mask", "gx", "gy", "gmask", "depth", "sigma"):
        av = [getattr(s, name) for s in a.scenes]
        bv = [getattr(s, name) for s in b.scenes]
        if any(v is None for v in av + bv):
            planes[name] = [None] * a.levels
        else:
            planes[name] = _select_planes(flag, av, bv)
    scenes = tuple(
        Scene(K=torch.where(flag, sa.K, sb.K), **{k: v[i] for k, v in planes.items()})
        for i, (sa, sb) in enumerate(zip(a.scenes, b.scenes)))
    pick = lambda x, y: torch.where(flag, x, y)
    return Frame(scenes=scenes, xi=pick(a.xi, b.xi), relative_xi=pick(a.relative_xi, b.relative_xi),
                 age=pick(a.age, b.age), frame_id=pick(a.frame_id, b.frame_id))


def with_pose(frame: Frame, relative_xi: torch.Tensor, ref_xi: torch.Tensor) -> Frame:
    """updateXi: world pose = compose(ref pose, relative pose) (frame.cpp:7-14)."""
    return dataclasses.replace(frame, relative_xi=relative_xi,
                               xi=lie.compose(ref_xi, relative_xi))


def _with_pairs(frame: Frame, pairs, age) -> Frame:
    scenes = tuple(dataclasses.replace(s, depth=d, sigma=sg)
                   for s, (d, sg) in zip(frame.scenes, pairs))
    return dataclasses.replace(frame, scenes=scenes,
                               age=age if age is not None else frame.age)


def with_depth(frame: Frame, depth, sigma=None, age=None) -> Frame:
    """Re-derive every level's depth (and optionally sigma) from a new
    base-level map by culling (frame.cpp:39-61): one
    ``csrc/framebuild.cu`` launch on CUDA."""
    if sigma is not None:
        pairs = cull_pyramid_pair(depth, sigma, frame.levels)
    else:
        pairs = [(d, s.sigma) for d, s in zip(cull_pyramid_one(depth, frame.levels),
                                              frame.scenes)]
    return _with_pairs(frame, pairs, age)


def with_base_depth(frame: Frame, depth, sigma) -> Frame:
    """``frame`` with ``depth``/``sigma`` on its base level only: what the
    keyframe ring reads of a new keyframe (``history.push``), with no cull."""
    base = dataclasses.replace(frame.base, depth=depth, sigma=sigma)
    return dataclasses.replace(frame, scenes=frame.scenes[:-1] + (base,))


def with_regularized_depth_plain(frame: Frame, depth, sigma, age,
                                 cfg: MapperConfig = MapperConfig()) -> Frame:
    """``with_depth`` of the new maps, the regulariser on the base level,
    ``with_depth`` of its output: the mapper's three steps one by one (on
    CUDA three launches: the pair build, ``csrc/regularize.cu``, the
    one-plane build)."""
    frame = with_depth(frame, depth, sigma, age)
    return with_depth(frame, regularize(frame.base.depth, frame.base.sigma, cfg))


def with_regularized_depth(frame: Frame, depth, sigma, age,
                           cfg: MapperConfig = MapperConfig()) -> Frame:
    """``frame`` with the regularised ``depth`` and the unchanged ``sigma``
    culled to every level, and ``age`` (mapper.cpp:30,139-144 after
    frame.cpp:39-61).  CPU tensors run ``with_regularized_depth_plain``; on
    CUDA the regulariser and both culls are one launch
    (``regularize_cull_pyramid``), equal to the plain version bit for bit."""
    if resolve_device(depth) == "plain":
        return with_regularized_depth_plain(frame, depth, sigma, age, cfg)
    return _with_pairs(frame, regularize_cull_pyramid(depth, sigma, frame.levels, cfg), age)
