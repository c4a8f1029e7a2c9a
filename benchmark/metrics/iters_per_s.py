"""iters_per_s: the Adam iterations of every ``Grape`` solve of the
window over the wall time of those solves, each timed whole (front end,
segments, analysis and float64 readout)."""


def read(ctx):
    wall = sum(ctx.solve_walls)
    if not ctx.solve_walls or wall <= 0:
        return None
    return sum(ctx.solve_iterations) / wall
