"""Device meshes for the VO workload — ``dvo_tpu.parallel.mesh`` on
``torch.distributed``.

Axes, with ``dvo_tpu``'s names:
  * ``tile``   — image-row tiles of the dense per-pixel loops;
  * ``kf``     — keyframes of the BA window;
  * ``stream`` — independent camera streams (``parallel.streams``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one device per rank: a rank's card with NCCL, its CPU
with gloo.  A single process that has joined no group gets a one-rank group
of its own over an in-process store (no address, no port), so the same code
runs on one device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def world_size() -> int:
    """Ranks in the process group (1 when there is none yet)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_group() -> None:
    """A one-rank process group for a single process that has none: NCCL
    with a card, gloo without."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type() == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape, axis_names) -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) ranks, named
    ``axis_names``: the ranks' cards when there are cards, else their CPUs.
    Every rank of the group must call it."""
    kind = device_type()
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    ensure_group()
    have = dist.get_world_size()
    if n > have:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    if n == have:
        return init_device_mesh(kind, shape, mesh_dim_names=tuple(axis_names))
    return DeviceMesh(kind, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axis_names))


def vo_mesh_shape(n: int) -> tuple:
    """``dvo_tpu``'s factoring of n devices into (kf, tile): kf is 4 or 2
    when that divides n and leaves a tile axis of at least 2, else 1."""
    kf = 1
    for cand in (4, 2):
        if n % cand == 0 and n // cand >= 2:
            kf = cand
            break
    return kf, n // kf


def vo_mesh(n_devices=None) -> DeviceMesh:
    """Default VO mesh: the ranks factored into (kf, tile)
    (``vo_mesh_shape``)."""
    n = n_devices if n_devices is not None else world_size()
    return make_mesh(vo_mesh_shape(n), ("kf", "tile"))
