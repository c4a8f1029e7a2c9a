"""kernel_roofline_pct (``.single`` and ``.batch``): the least time the
card could take for one iteration's work (the larger of its operations
over the float32 peak and its bytes over the memory's peak,
``benchmark/work``), over the device's busy time per iteration in the
traced window, in %."""

from benchmark import trace


def read(ctx):
    busy = trace.busy_ns(ctx.events, ctx.lo, ctx.hi) * 1e-9
    if ctx.iterations <= 0 or busy <= 0:
        return None
    least = max(ctx.work["flops"] / ctx.peak["flops"],
                ctx.work["bytes"] / ctx.peak["bytes"])
    return 100.0 * least / (busy / ctx.iterations)
