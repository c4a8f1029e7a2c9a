"""boundary_us (``.single`` and ``.batch``): the median duration, in us,
of the host's work after each ``update_step`` segment inside the traced
window: ``Grape``'s ``qoc.grape.boundary`` (the history row, the progress
line, the host copy of the pulses) or ``batched_grape_adam``'s
``qoc.batch.boundary`` (the gathers the ``progress`` hook gets, and the
hook; the all(done) read that waits for the card closes the segment).

The value is host time under the profiler, which adds some 10-30 us to
each operator the span holds: it reads above the untraced boundary, and
falls faster than the untraced boundary when an operator goes.  Compare
it only between traced runs, with the operator count."""

import statistics

from benchmark import trace

NAMES = ("qoc.grape.boundary", "qoc.batch.boundary")


def read(ctx):
    d = [t - s for name in NAMES for s, t in trace.spans(ctx.events, name)
         if ctx.lo <= s and t <= ctx.hi]
    return statistics.median(d) * 1e-3 if d else None
