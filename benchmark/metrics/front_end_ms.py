"""front_end_ms (``.single`` and ``.batch``): the median duration, in ms,
of the entry's front-end span inside the traced window: ``Grape``'s
``qoc.grape.front_end`` (the method check to the first segment: the
problem's build with the Taylor pre-pass, both forwards, the routing, the
runner's build, the initial state) or ``batched_grape_adam``'s
``qoc.batch.front_end`` (validation to the initial state: routing, the
runner's build, the seeds, the weights' upload).  A cell runs one of the
two entries."""

import statistics

from benchmark import trace

NAMES = ("qoc.grape.front_end", "qoc.batch.front_end")


def read(ctx):
    d = [t - s for name in NAMES for s, t in trace.spans(ctx.events, name)
         if ctx.lo <= s and t <= ctx.hi]
    return statistics.median(d) * 1e-6 if d else None
