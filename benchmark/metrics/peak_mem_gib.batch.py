"""peak_mem_gib: the allocator's peak over the traced window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``),
in GiB."""


def read(ctx):
    if ctx.peak_mem_bytes is None:
        return None
    return ctx.peak_mem_bytes / 2 ** 30
