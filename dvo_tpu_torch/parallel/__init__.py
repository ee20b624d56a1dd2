"""Device-mesh sharding of tracking, mapping, bundle adjustment and camera
streams on ``torch.distributed`` — ``dvo_tpu.parallel`` ported.

  * ``tracking`` — tile-sharded GN (``sharded_gn_normal_equations``,
    ``sharded_track_level``, ``sharded_track``): image rows over the
    ``tile`` axis, one ``csrc/gn.cu`` launch per rank and GN step on its row
    block, the 44 sums all-reduced;
  * ``mapping`` — the tile-sharded epipolar depth update
    (``sharded_depth_update``): one launch of the fused ``csrc/epipolar.cu``
    entry per rank on its row block, the maps all-gathered;
  * ``ba`` — keyframe-sharded windowed BA (``bundle_adjust_sharded``): host
    keyframes over the ``kf`` axis, the reduced camera system all-reduced;
  * ``streams`` — independent camera streams over the ``stream`` axis;
  * ``mesh``, ``distributed`` — meshes and multi-process bring-up.

Inputs are whole tensors on every rank (as ``shard_map`` takes them); each
rank takes its own rows or keyframes, and every rank returns the whole
result.  How to run them:
  * one process: a mesh makes a one-rank group of its own
    (``vo_mesh()``: NCCL on the card);
  * several cards: ``torchrun --nproc-per-node N script.py``, where the
    script calls ``initialize()`` and then builds its mesh
    (``pod_mesh()``, ``vo_mesh()``, ``make_mesh(shape, names)``);
  * the CPU: pass ``device="cpu"`` to ``initialize`` and to the mesh
    (gloo); the tests run four gloo processes so.
Meshes and ``initialize`` default to ``device="cuda"`` and raise without a
card.  A gloo group may also carry tensors on the card (several processes
on one card, where NCCL refuses): the collectives' payloads then travel
through the host, and the kernels still run on the card.
"""

from dvo_tpu_torch.parallel.ba import bundle_adjust_sharded
from dvo_tpu_torch.parallel.distributed import initialize, pod_mesh
from dvo_tpu_torch.parallel.mapping import sharded_depth_update
from dvo_tpu_torch.parallel.mesh import make_mesh, vo_mesh
from dvo_tpu_torch.parallel.streams import monocular_run_streams, rgbd_run_streams, stream_mesh
from dvo_tpu_torch.parallel.tracking import (
    sharded_gn_normal_equations,
    sharded_track,
    sharded_track_level,
)

__all__ = [
    "bundle_adjust_sharded",
    "initialize",
    "make_mesh",
    "monocular_run_streams",
    "pod_mesh",
    "rgbd_run_streams",
    "sharded_depth_update",
    "sharded_gn_normal_equations",
    "sharded_track",
    "sharded_track_level",
    "stream_mesh",
    "vo_mesh",
]
