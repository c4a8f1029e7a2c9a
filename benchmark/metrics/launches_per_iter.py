"""launches_per_iter (``.single`` and ``.batch``): the kernels, copies
and sets the device ran in the traced window, over the Adam iterations
of that window (an exact count)."""

from benchmark import trace


def read(ctx):
    if ctx.iterations <= 0:
        return None
    return trace.device_count(ctx.events, ctx.lo, ctx.hi) / ctx.iterations
