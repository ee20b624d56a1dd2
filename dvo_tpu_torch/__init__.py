"""dvo_tpu_torch — the dvo_tpu monocular and RGB-D pipelines in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port beside the JAX package, which stays the reference.  Module names
mirror ``dvo_tpu`` so each module's counterpart is easy to find:

  dvo_tpu_torch.config    — ``dvo_tpu.config``'s dataclasses + ``resolve_device``
  dvo_tpu_torch.lie       — SE(3)/SO(3)
  dvo_tpu_torch.ops       — decimation, gradients, sampling, warping, depth filter
  dvo_tpu_torch.ops.cuda  — the four kernels (GN, epipolar, regularize, frame
                            build), each with its plain PyTorch version and a
                            launch count
  dvo_tpu_torch.models    — frame, keyframe ring, tracker, mapper, odometry

Every kernel wrapper runs the kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor.  The package never imports ``jax``.
"""

from dvo_tpu_torch.config import DVOConfig, MapperConfig, PyramidConfig, TrackerConfig

__all__ = ["DVOConfig", "MapperConfig", "PyramidConfig", "TrackerConfig"]
