"""launch_prep_us (``.single`` and ``.batch``): the median duration, in
us, of a fused kernel's launch path inside the traced window, from the
segment runner's entry to the launch wrapper's return: kernel 3's
``qoc.mega.prepare`` or kernel 6's ``qoc.mega_batch.prepare`` (scratch,
the clones of the state, the scalars' upload, the wrapper's checks and
the launch call).

The value is host time under the profiler, which adds some 10-30 us to
each operator the span holds (about ten here): it reads 2-4x the
untraced path, and falls faster than the untraced path when an operator
goes.  Compare it only between traced runs, with the operator count."""

import statistics

from benchmark import trace

NAMES = ("qoc.mega.prepare", "qoc.mega_batch.prepare")


def read(ctx):
    d = [t - s for name in NAMES for s, t in trace.spans(ctx.events, name)
         if ctx.lo <= s and t <= ctx.hi]
    return statistics.median(d) * 1e-3 if d else None
