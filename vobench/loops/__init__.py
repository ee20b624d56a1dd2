"""The traffic loops.  A mix (``vobench/traffic/<mix>.json``) names its
loop under ``loop``; the harness imports ``vobench/loops/<loop>.py`` by
that name.  A loop module exports

* ``run(config, traffic, seed, seconds, trace, device="cuda",
  setup_clock=None, shape=None) -> drivers.Run``: set-up, the measured
  window of ``seconds``, and with ``trace`` a profiled part before it;
* ``judge(config, traffic, run, control=False) -> judge.Readings``: the
  numbers the cell's limits name, on the program's outputs, or with
  ``control`` on the reference's own computed with TF32 in its place.

A new loop is a new module here and a mix that names it; no file that is
there changes."""
