"""``issue_host_us_per_frame``, in the RGB-D cells, where it moves ``frames_per_s.rgbd``."""

from vobench.harness import reader

read = reader("issue_host_us_per_frame")
