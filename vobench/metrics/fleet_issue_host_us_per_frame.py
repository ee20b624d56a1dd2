"""``issue_host_us_per_frame`` in a fleet, over its stream-frames: the
host time of the issue loop, which enqueues every stream's frame in turn."""

from vobench.harness import reader

read = reader("issue_host_us_per_frame")
