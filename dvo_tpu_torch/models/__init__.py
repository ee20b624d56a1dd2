"""Frame, keyframe ring, tracker, mapper and the monocular odometry driver."""
