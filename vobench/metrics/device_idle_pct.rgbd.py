"""``device_idle_pct.offline``, in the RGB-D cells, where it moves ``frames_per_s.rgbd``."""

from vobench.harness import reader

read = reader("device_idle_pct.offline")
