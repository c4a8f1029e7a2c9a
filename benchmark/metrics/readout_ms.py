"""readout_ms (``.single``): the median duration, in ms, of the entry's
readout span inside the traced window: ``Grape``'s ``qoc.grape.readout``
(the host copy of the pulses, the analysis forward, the copies to the
host, ``uks``, the float64 fidelity, ``Uf``), or ``batched_grape_adam``'s
``qoc.batch.readout`` (the gathers, ``argmin``, ``uks``)."""

import statistics

from benchmark import trace

NAMES = ("qoc.grape.readout", "qoc.batch.readout")


def read(ctx):
    d = [t - s for name in NAMES for s, t in trace.spans(ctx.events, name)
         if ctx.lo <= s and t <= ctx.hi]
    return statistics.median(d) * 1e-6 if d else None
