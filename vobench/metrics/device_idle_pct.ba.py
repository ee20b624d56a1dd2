"""``device_idle_pct.offline``, in the windowed-BA cell."""

from vobench.harness import reader

read = reader("device_idle_pct.offline")
