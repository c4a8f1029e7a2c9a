"""solve_ms.p90: the 90th percentile of the wall time of the window's
whole ``Grape`` solves, in ms (the inclusive quantile of all of them)."""

import statistics


def read(ctx):
    walls = [1e3 * w for w in ctx.solve_walls]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
