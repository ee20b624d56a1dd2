"""Fixed-capacity keyframe ring — ``dvo_tpu.models.history`` ported.

Keyframes live in stacked (C, H, W) tensors; the keyframe a pixel's depth
was born in is ``slot = (head - age) mod C`` (reference frame.hpp:176).
``head`` and ``count`` are 0-d int32 tensors on the ring's device, as in
``dvo_tpu``: the monocular step decides promotion on the device, so a push
takes a device flag and writes its slot with ``torch.where`` — no host
read.  Updates copy the stacks (a few MB per step) so that an older state
stays valid.  ``host_ints`` reads ``head`` and ``count`` to the host in one
copy, for the host-side consumers (the pose graph, the gallery).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dvo_tpu_torch.models.frame import Frame, device_int


@dataclasses.dataclass(frozen=True)
class KeyframeHistory:
    gray: torch.Tensor    # (C, H, W) float32
    mask: torch.Tensor    # (C, H, W) bool
    gx: torch.Tensor      # (C, H, W) float32
    gy: torch.Tensor      # (C, H, W) float32
    gmask: torch.Tensor   # (C, H, W) bool
    depth: torch.Tensor   # (C, H, W) keyframe depth at push / refresh time
    sigma: torch.Tensor   # (C, H, W)
    xi: torch.Tensor      # (C, 6) world pose twists
    kf_id: torch.Tensor   # (C,) int32 frame_id per slot, -1 = never written
    head: torch.Tensor    # () int32 slot of the newest keyframe (a Python int is converted)
    count: torch.Tensor   # () int32 live keyframes (<= C)

    def __post_init__(self):
        for name in ("head", "count"):
            object.__setattr__(self, name, device_int(getattr(self, name), self.gray.device))

    @property
    def capacity(self) -> int:
        return self.gray.shape[-3]   # (C, H, W), or (B, C, H, W) for B streams

    @staticmethod
    def create(capacity: int, h: int, w: int, device=None) -> "KeyframeHistory":
        f32 = dict(dtype=torch.float32, device=device)
        return KeyframeHistory(
            gray=torch.zeros((capacity, h, w), **f32),
            mask=torch.zeros((capacity, h, w), dtype=torch.bool, device=device),
            gx=torch.zeros((capacity, h, w), **f32),
            gy=torch.zeros((capacity, h, w), **f32),
            gmask=torch.zeros((capacity, h, w), dtype=torch.bool, device=device),
            depth=torch.zeros((capacity, h, w), **f32),
            sigma=torch.ones((capacity, h, w), **f32),
            xi=torch.zeros((capacity, 6), **f32),
            kf_id=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            head=-1,
            count=0,
        )


def host_ints(history: KeyframeHistory):
    """(head, count) as Python ints, read in one device-to-host copy."""
    head, count = torch.stack([history.head, history.count]).tolist()
    return head, count


def _selector(history: KeyframeHistory, slot, flag):
    """(C,) bool: ring slot ``slot`` where ``flag`` holds (None: always)."""
    sel = torch.arange(history.capacity, device=history.gray.device) == slot
    return sel if flag is None else sel & flag


def _set(stack: torch.Tensor, sel: torch.Tensor, value) -> torch.Tensor:
    """A new stack: ``value`` in the selected slots, the old entries
    elsewhere (``torch.where``: never an in-place write, no host read)."""
    return torch.where(sel.view((-1,) + (1,) * (stack.dim() - 1)), value, stack)


def push(history: KeyframeHistory, frame: Frame,
         flag: Optional[torch.Tensor] = None) -> KeyframeHistory:
    """Append ``frame`` as the newest keyframe (setRefFrame,
    frame.hpp:152-158); the oldest slot is overwritten once full.  With a
    device bool ``flag`` the push happens only where it holds:
    ``head' = where(flag, (head + 1) % C, head)``, ``count'`` likewise, and
    the slot keeps its old entry otherwise."""
    s = frame.base
    slot = torch.remainder(history.head + 1, history.capacity)
    sel = _selector(history, slot, flag)
    count = torch.clamp(history.count + 1, max=history.capacity)
    if flag is not None:
        slot = torch.where(flag, slot, history.head)
        count = torch.where(flag, count, history.count)
    return dataclasses.replace(
        history,
        gray=_set(history.gray, sel, s.gray),
        mask=_set(history.mask, sel, s.mask),
        gx=_set(history.gx, sel, s.gx),
        gy=_set(history.gy, sel, s.gy),
        gmask=_set(history.gmask, sel, s.gmask),
        depth=_set(history.depth, sel, s.depth),
        sigma=_set(history.sigma, sel, s.sigma),
        xi=_set(history.xi, sel, frame.xi),
        kf_id=_set(history.kf_id, sel, frame.frame_id),
        head=slot.to(torch.int32),
        count=count.to(torch.int32),
    )


def refresh_head(history: KeyframeHistory, frame: Frame,
                 flag: Optional[torch.Tensor] = None) -> KeyframeHistory:
    """Write the reference keyframe's current depth, sigma and pose back
    into its slot before the next keyframe is pushed (where ``flag`` holds,
    when one is given)."""
    s = frame.base
    sel = _selector(history, history.head, flag)
    return dataclasses.replace(
        history,
        depth=_set(history.depth, sel, s.depth),
        sigma=_set(history.sigma, sel, s.sigma),
        xi=_set(history.xi, sel, frame.xi),
    )


def born_slot(history: KeyframeHistory, age: torch.Tensor) -> torch.Tensor:
    """Ring slot of the keyframe ``age`` promotions before the newest;
    ages beyond the live window clamp to the oldest retained keyframe."""
    age = torch.minimum(torch.clamp(age, min=0), torch.clamp(history.count - 1, min=0))
    return torch.remainder(history.head - age, history.capacity)
