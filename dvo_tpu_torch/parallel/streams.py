"""Multi-stream scaling over ranks — ``dvo_tpu.parallel.streams`` on
``torch.distributed``: one or more camera streams per device.

``dvo_tpu`` shard_maps its batched chunk driver over a ``stream`` mesh axis.
Here every rank takes its B/D rows of the global inputs and runs them
through the batched drivers (``monocular_run_batched``,
``rgbd_run_batched``: one graphed step driver per stream on the card) on its
own device, with no collective during the chunk.  At the chunk's end one
``all_gather`` per dtype gives every rank the results and states of all B
streams, which is what ``dvo_tpu``'s global arrays hold.  The gathered
state keeps the live generators of the rank's own streams; the others are
copies of their owners' generators.  A rank's graphed drivers are cached
with the gathered state, so the next chunk replays them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from dvo_tpu_torch.config import DVOConfig
from dvo_tpu_torch.models import graphed
from dvo_tpu_torch.models.odometry import (
    monocular_run_batched,
    rgbd_run_batched,
    select_streams,
)
from dvo_tpu_torch.parallel.mesh import all_gather_rows, make_mesh, wire, world_size


def stream_mesh(n_devices=None, device: str = "cuda"):
    """1-D mesh over the ``stream`` axis (default: every rank), on the
    ranks' cards or, with ``device="cpu"``, their CPUs
    (``mesh.make_mesh``)."""
    return make_mesh((n_devices if n_devices is not None else world_size(),), ("stream",),
                     device)


def _rows(mesh, streams: int):
    """This rank's rows of B streams, and the axis' group.  Refuses, as
    ``dvo_tpu``'s shard_map does, a B that the axis does not divide."""
    d = mesh.size()
    if streams % d:
        raise ValueError(
            f"the stream driver was given arrays with axis sizes that are not evenly "
            f"divisible by the corresponding mesh axis sizes: mesh axis 'stream' (of size "
            f"{d}) does not evenly divide {streams} streams")
    per = streams // d
    r = mesh.get_local_rank("stream")
    return slice(r * per, (r + 1) * per), mesh.get_group("stream")


def _gather_generators(mine: tuple, group) -> tuple:
    """The generators of all B streams on every rank, from each rank's own
    (``mine``): this rank's live objects and new ones set to the other
    ranks' states."""
    states = torch.stack([g.get_state() for g in mine])
    on = wire(group)
    parts = [torch.empty_like(states, device=on) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, states.to(on), group=group)
    out = []
    for r, part in enumerate(parts):
        if r == dist.get_rank(group):
            out.extend(mine)
            continue
        for state in part.cpu():
            g = torch.Generator(device=mine[0].device)
            g.set_state(state)
            out.append(g)
    return tuple(out)


def _gather(tree, group):
    gathered = iter(all_gather_rows(graphed.leaves(tree), group))
    out = graphed.tree_map(lambda _: next(gathered), tree)
    if isinstance(getattr(tree, "generator", None), tuple):
        out = dataclasses.replace(out, generator=_gather_generators(tree.generator, group))
    return out


def _sharded(run, mesh, states, inputs, K):
    """``run(states, inputs, K)`` (a batched driver) on this rank's rows,
    then gathered."""
    rows, group = _rows(mesh, inputs[0].shape[0])
    local = select_streams(states, rows)
    graphed.carry(local, states)
    st, res = run(local, [x[rows] for x in inputs], K[rows] if K.dim() == 3 else K)
    out = _gather(st, group)
    graphed.carry(out, st)
    return out, _gather(res, group)


def monocular_run_streams(mesh, states, grays, masks, K, cfg: DVOConfig = DVOConfig.monocular(),
                          reset_depths=None):
    """Chunked multi-stream driver over the mesh: ``states`` is a stack of B
    states (``monocular_init_batched``), grays/masks (B, N, H, W) (masks also
    (B, H, W)), K shared (3, 3) or (B, 3, 3), ``reset_depths`` (B, N, h, w)
    or None.  B must divide by the ``stream`` axis; each rank runs its B/D
    streams (``monocular_run_batched``) with no collective, then gathers.
    Returns (the stack of states', StepResult with leading (B, N) axes)."""
    inputs = [torch.as_tensor(x) for x in (grays, masks)]
    if reset_depths is not None:
        inputs.append(torch.as_tensor(reset_depths))
    return _sharded(lambda st, x, k: monocular_run_batched(
        st, x[0], x[1], k, cfg, x[2] if len(x) > 2 else None),
        mesh, states, inputs, torch.as_tensor(K))


def rgbd_run_streams(mesh, states, grays, masks, depths, sigmas, K,
                     cfg: DVOConfig = DVOConfig.rgbd()):
    """RGB-D twin of ``monocular_run_streams``: B frame-to-frame tracking
    pipelines sharded over the ``stream`` axis (grays/masks/depths/sigmas:
    (B, N, H, W))."""
    inputs = [torch.as_tensor(x) for x in (grays, masks, depths, sigmas)]
    return _sharded(lambda st, x, k: rgbd_run_batched(st, *x, k, cfg),
                    mesh, states, inputs, torch.as_tensor(K))
