"""setup_s: seconds from the start of the process to the opening of the
measured window (imports, the card's start, loading or building the
kernels, the configuration, and the warm-up call that the check reads)."""


def read(ctx):
    return ctx.setup_s
