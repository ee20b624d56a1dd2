"""The fleet's frames a second in the window, summed over its streams, as
``frames_per_s`` reads them.  Per layer: the host's issue bounds the
fleet, so its rate follows the speed of the host's CPU, which wanders from
run to run by more than any bound could hold (``PERF.md``, section 2)."""

from vobench.harness import reader

read = reader("frames_per_s")
