"""Device meshes and the stream-sharded drivers on ``torch.distributed``
(``dvo_tpu.parallel``'s ``mesh``, ``distributed`` and ``streams``).

The tile- and keyframe-sharded solvers of ``dvo_tpu.parallel`` (its
``tracking``, ``mapping`` and ``ba``) are not ported yet: they need a row
offset in the kernels and an all-reduce inside the GN loop.
"""

from dvo_tpu_torch.parallel.distributed import initialize, pod_mesh
from dvo_tpu_torch.parallel.mesh import make_mesh, vo_mesh
from dvo_tpu_torch.parallel.streams import monocular_run_streams, rgbd_run_streams, stream_mesh

__all__ = [
    "initialize",
    "make_mesh",
    "monocular_run_streams",
    "pod_mesh",
    "rgbd_run_streams",
    "stream_mesh",
    "vo_mesh",
]
