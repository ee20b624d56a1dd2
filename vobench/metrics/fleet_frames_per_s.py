"""The fleet's frames a second: ``frames_per_s``, summed over its streams,
a metric of its own so that a fleet's spread has a bound of its own."""

from vobench.harness import reader

read = reader("frames_per_s")
