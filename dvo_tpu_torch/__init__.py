"""dvo_tpu_torch — the dvo_tpu monocular and RGB-D pipelines in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port beside the JAX package, which stays the reference.  Module names
mirror ``dvo_tpu`` so each module's counterpart is easy to find:

  dvo_tpu_torch.config    — the configuration dataclasses (its own copy, same
                            fields and presets), ``config_from_reference``,
                            ``resolve_device``
  dvo_tpu_torch.lie       — SE(3)/SO(3)
  dvo_tpu_torch.ops       — decimation, gradients, sampling, warping, depth filter
  dvo_tpu_torch.ops.cuda  — the five kernels (GN step, GN level loop, epipolar,
                            regularize, frame build), each with its plain
                            PyTorch version, a launch count and its work()
  dvo_tpu_torch.models    — frame, keyframe ring, tracker, mapper, odometry,
                            windowed bundle adjustment, pose graph
  dvo_tpu_torch.utils     — runners, datasets, trajectory, metrics, checkpoints,
                            streams, visualisation, the NumPy oracle, the
                            dataset recorder
  dvo_tpu_torch.native    — C++ PNG decode, remap and prefetch loader

Every kernel wrapper runs the kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor.  The package imports neither ``jax`` nor
``dvo_tpu``: it keeps its own copy of everything it needs.
"""

from dvo_tpu_torch.config import DVOConfig, MapperConfig, PyramidConfig, TrackerConfig

__all__ = ["DVOConfig", "MapperConfig", "PyramidConfig", "TrackerConfig"]
