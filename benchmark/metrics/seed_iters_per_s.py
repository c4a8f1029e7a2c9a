"""seed_iters_per_s: the iterations the seeds of the window's sweeps
stepped while not frozen, summed over seeds, over the window's wall
time.  A segment counts, for each seed not frozen at its start, the
iterations it advanced."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.seed_iterations <= 0:
        return None
    return ctx.seed_iterations / ctx.window_s
