"""Frame, keyframe ring, tracker, mapper, the odometry drivers, windowed
bundle adjustment and the pose graph."""
