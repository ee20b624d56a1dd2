"""Frame, keyframe ring, tracker, mapper, the odometry drivers, windowed
bundle adjustment and the pose graph."""

from dvo_tpu_torch.models.frame import Scene, Frame, build_frame, build_frame_with_depth
from dvo_tpu_torch.models.tracker import track, TrackResult

__all__ = [
    "Scene",
    "Frame",
    "build_frame",
    "build_frame_with_depth",
    "track",
    "TrackResult",
]
