"""``step_device_ops_per_frame``, in the RGB-D cells, where it moves ``frames_per_s.rgbd``."""

from vobench.harness import reader

read = reader("step_device_ops_per_frame")
