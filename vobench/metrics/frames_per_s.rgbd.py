"""RGB-D frames a second: ``frames_per_s``, a metric of its own so that
RGB-D's wider spread has a bound of its own and leaves monocular's tight."""

from vobench.harness import reader

read = reader("frames_per_s")
