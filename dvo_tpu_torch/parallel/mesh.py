"""Device meshes for the VO workload — ``dvo_tpu.parallel.mesh`` on
``torch.distributed``.

Axes, with ``dvo_tpu``'s names:
  * ``tile``   — image-row tiles of the dense per-pixel loops
    (``parallel.tracking``, ``parallel.mapping``);
  * ``kf``     — keyframes of the BA window (``parallel.ba``);
  * ``stream`` — independent camera streams (``parallel.streams``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one device per rank.  Every entry point takes the device
kind it runs on: ``device="cuda"`` (the default) is NCCL on the rank's card
and raises without a card; ``device="cpu"`` is gloo on the CPU, and is only
taken when asked for.  A single process that has joined no group gets a
one-rank group of its own over an in-process store (no address, no port),
so the same code runs on one device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device: str) -> str:
    """The process group backend of a device kind: NCCL for ``"cuda"``,
    gloo for ``"cpu"``.  ``"cuda"`` without a card raises: nothing falls
    back to the CPU unless the CPU is asked for."""
    if device not in BACKENDS:
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda': no CUDA device (torch.cuda.is_available() is "
                           "False); pass device='cpu' for gloo on the CPU")
    return BACKENDS[device]


def wire(group) -> str:
    """The device a collective's payload travels on over ``group``: the
    card for NCCL, the host for gloo (a payload on the card is copied to the
    host and back)."""
    return "cuda" if dist.get_backend(group) == "nccl" else "cpu"


def world_size() -> int:
    """Ranks in the process group (1 when there is none yet)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def ensure_group(device: str = "cuda") -> None:
    """A one-rank process group for a single process that has none: NCCL on
    the card for ``"cuda"``, gloo for ``"cpu"``."""
    backend = backend_for(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape, axis_names, device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) ranks, named
    ``axis_names``, on the ranks' cards (``"cuda"``) or CPUs (``"cpu"``).
    Every rank of the group must call it."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    ensure_group(device)
    have = dist.get_world_size()
    if n > have:
        raise ValueError(f"mesh {shape} needs {n} devices, have {have}")
    if n == have:
        return init_device_mesh(device, shape, mesh_dim_names=tuple(axis_names))
    return DeviceMesh(device, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axis_names))


def vo_mesh_shape(n: int) -> tuple:
    """``dvo_tpu``'s factoring of n devices into (kf, tile): kf is 4 or 2
    when that divides n and leaves a tile axis of at least 2, else 1."""
    kf = 1
    for cand in (4, 2):
        if n % cand == 0 and n // cand >= 2:
            kf = cand
            break
    return kf, n // kf


def vo_mesh(n_devices=None, device: str = "cuda") -> DeviceMesh:
    """Default VO mesh: the ranks factored into (kf, tile)
    (``vo_mesh_shape``)."""
    n = n_devices if n_devices is not None else world_size()
    return make_mesh(vo_mesh_shape(n), ("kf", "tile"), device)


def axis_group(mesh: DeviceMesh, axis: str) -> tuple:
    """(this rank's index along ``axis``, the axis' size, its process
    group): what ``shard_map``'s ``lax.axis_index`` and mesh shape give
    ``dvo_tpu``."""
    group = mesh.get_group(axis)
    return mesh.get_local_rank(axis), dist.get_world_size(group), group


def tile_rows(mesh: DeviceMesh, axis: str, h: int) -> tuple:
    """(this rank's first row, the rows of its block, the axis' group) of
    ``h`` rows sharded over ``axis``.  Refuses, as ``dvo_tpu`` asserts, a
    height the axis does not divide."""
    rank, n_tiles, group = axis_group(mesh, axis)
    if h % n_tiles:
        raise ValueError(f"image height {h} not divisible by {n_tiles} tiles")
    bh = h // n_tiles
    return rank * bh, bh, group


def all_reduce_sum(tensors: list, group) -> list:
    """Each tensor of ``tensors`` summed over the group's ranks: one
    ``all_reduce`` per dtype, on ``wire(group)`` (the results come back on
    the tensors' device)."""
    on = wire(group)
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx]).to(on)
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[off:off + t.numel()].view(t.shape).to(t.device)
            off += t.numel()
    return out


def all_gather_rows(local: list, group) -> list:
    """Each tensor of ``local`` concatenated over the group's ranks along
    its leading axis, in rank order: one ``all_gather`` per dtype on
    ``wire(group)`` (bool travels as uint8), the results on the tensors'
    device."""
    on = wire(group)
    world = dist.get_world_size(group)
    out = [None] * len(local)
    by_dtype = {}
    for i, t in enumerate(local):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([local[i].reshape(-1) for i in idx]).to(on)
        if dtype == torch.bool:
            flat = flat.view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(parts, flat, group=group)
        if dtype == torch.bool:
            parts = [p.view(torch.bool) for p in parts]
        off = 0
        for i in idx:
            t, n = local[i], local[i].numel()
            out[i] = torch.cat([p[off:off + n].view(t.shape) for p in parts]).to(t.device)
            off += n
    return out
