"""Multi-process bring-up and the pod mesh — ``dvo_tpu.parallel.
distributed`` on ``torch.distributed``.

``initialize`` joins the process group when there is more than one process:
NCCL on the rank's card (``device="cuda"``, the default; it raises without a
card), or gloo on the CPU when ``device="cpu"`` is asked for, from the
standard ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` (as
``torchrun`` sets them) unless told otherwise.  For one process it does
nothing; a mesh then makes a one-rank group of its own
(``mesh.ensure_group``).

``pod_mesh`` lays (kf, tile) out as ``dvo_tpu`` does: ``tile`` the fast axis
over the ranks of one host (``LOCAL_WORLD_SIZE``), so the per-iteration
reduction of the tracking system stays inside a host, and ``kf`` across
hosts.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from dvo_tpu_torch.parallel.mesh import backend_for, make_mesh, world_size


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda") -> None:
    """Join the process group when running multi-process; a no-op for one
    process, or when the group exists.  ``coordinator_address`` ("host:port")
    defaults to ``MASTER_ADDR``:``MASTER_PORT``, ``num_processes`` to
    ``WORLD_SIZE``, ``process_id`` to ``RANK``; NCCL on the rank's card
    (``LOCAL_RANK``) for ``device="cuda"``, gloo for ``device="cpu"``."""
    backend = backend_for(device)
    n = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if (n <= 1 and coordinator_address is None) or dist.is_initialized():
        return
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=n, rank=rank)


def pod_mesh_shape(n: int, kf: Optional[int] = None, tile: Optional[int] = None,
                   local: Optional[int] = None) -> tuple:
    """``dvo_tpu``'s (kf, tile) for n devices: tile = devices per host
    (``local``; all n on one host) unless given or implied by kf, kf = the
    rest."""
    if tile is None:
        tile = n // max(kf, 1) if kf is not None else min(n if local is None else local, n)
    if kf is None:
        kf = n // tile
    if kf * tile != n:
        raise ValueError(f"pod mesh ({kf}, {tile}) does not cover {n} devices")
    return kf, tile


def pod_mesh(kf: Optional[int] = None, tile: Optional[int] = None, device: str = "cuda"):
    """(kf, tile) mesh over every rank of the group (``pod_mesh_shape``;
    devices per host from ``LOCAL_WORLD_SIZE`` when multi-process)."""
    n = world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n)) if n > 1 else n
    return make_mesh(pod_mesh_shape(n, kf, tile, local), ("kf", "tile"), device)
