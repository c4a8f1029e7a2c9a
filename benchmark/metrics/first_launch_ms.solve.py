"""first_launch_ms.solve: for each traced ``Grape`` solve, the ms from
the start of the benchmark's span around the call to the first CUDA
launch or copy call inside it (the entry's front end: the problem's
build, the forwards, the routing); the median over the solves."""

import statistics

from benchmark import trace


def read(ctx):
    firsts = []
    launches = sorted(e.start for e in ctx.events if e.kind == "launch")
    for lo, hi in trace.spans(ctx.events, "bench.solve"):
        inside = [s for s in launches if lo <= s < hi]
        if inside:
            firsts.append((inside[0] - lo) * 1e-6)
    return statistics.median(firsts) if firsts else None
