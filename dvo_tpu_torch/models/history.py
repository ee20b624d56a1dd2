"""Fixed-capacity keyframe ring — ``dvo_tpu.models.history`` ported.

Keyframes live in stacked (C, H, W) tensors; the keyframe a pixel's depth
was born in is ``slot = (head - age) mod C`` (reference frame.hpp:176).
``head`` and ``count`` are Python ints: they change only on promotion,
which is a host decision in the port.  Updates copy the stacks (a few MB
per promotion) so that an older state stays valid.
"""

from __future__ import annotations

import dataclasses

import torch

from dvo_tpu_torch.models.frame import Frame


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
    head: int             # slot of the newest keyframe
    count: int            # live keyframes (<= C)

    @property
    def capacity(self) -> int:
        return self.gray.shape[0]

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


def _set(stack: torch.Tensor, slot: int, value) -> torch.Tensor:
    out = stack.clone()
    if isinstance(value, torch.Tensor):
        out[slot] = value
    else:
        out[slot].fill_(value)  # a Python scalar stored with `=` syncs on CUDA
    return out


def push(history: KeyframeHistory, frame: Frame) -> KeyframeHistory:
    """Append ``frame`` as the newest keyframe (setRefFrame,
    frame.hpp:152-158); the oldest slot is overwritten once full."""
    s = frame.base
    slot = (history.head + 1) % history.capacity
    return dataclasses.replace(
        history,
        gray=_set(history.gray, slot, s.gray),
        mask=_set(history.mask, slot, s.mask),
        gx=_set(history.gx, slot, s.gx),
        gy=_set(history.gy, slot, s.gy),
        gmask=_set(history.gmask, slot, s.gmask),
        depth=_set(history.depth, slot, s.depth),
        sigma=_set(history.sigma, slot, s.sigma),
        xi=_set(history.xi, slot, frame.xi),
        kf_id=_set(history.kf_id, slot, frame.frame_id),
        head=slot,
        count=min(history.count + 1, history.capacity),
    )


def refresh_head(history: KeyframeHistory, frame: Frame) -> KeyframeHistory:
    """Write the reference keyframe's current depth, sigma and pose back
    into its slot before the next keyframe is pushed."""
    s = frame.base
    slot = history.head
    return dataclasses.replace(
        history,
        depth=_set(history.depth, slot, s.depth),
        sigma=_set(history.sigma, slot, s.sigma),
        xi=_set(history.xi, slot, frame.xi),
    )


def write_back(history: KeyframeHistory, slots, xi, depth) -> KeyframeHistory:
    """Write bundle-adjusted world poses and depth maps into ring slots:
    ``slots`` a list of M ints (``ba.window_slots``), ``xi`` (M, 6),
    ``depth`` (M, H, W).  The writes go into copies of the stacks, one
    indexed copy per slot, and read nothing back to the host."""
    new_xi, new_depth = history.xi.clone(), history.depth.clone()
    for a, slot in enumerate(slots):
        new_xi[slot] = xi[a]
        new_depth[slot] = depth[a]
    return dataclasses.replace(history, xi=new_xi, depth=new_depth)


def born_slot(history: KeyframeHistory, age: torch.Tensor) -> torch.Tensor:
    """Ring slot of the keyframe ``age`` promotions before the newest;
    ages beyond the live window clamp to the oldest retained keyframe."""
    age = torch.clamp(age, 0, max(history.count - 1, 0))
    return torch.remainder(history.head - age, history.capacity)
