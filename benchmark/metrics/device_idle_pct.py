"""device_idle_pct (``.single`` and ``.batch``): the share of the traced
window in which no kernel, copy or set runs on the device (the union of
the profiler's device intervals), in %."""

from benchmark import trace


def read(ctx):
    span = ctx.hi - ctx.lo
    busy = trace.busy_ns(ctx.events, ctx.lo, ctx.hi)
    if span <= 0 or busy <= 0:
        return None
    return 100.0 * (span - busy) / span
