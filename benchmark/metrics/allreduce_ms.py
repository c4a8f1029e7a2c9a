"""allreduce_ms (``.batch``): the median, over the traced window's
segments and every rank, of the device time in ms of the NCCL
all-reduce kernel that the batch layer's sharded runner issues once a
segment on each rank (the global iteration and the stop flag,
``parallel/batch.py`` ``_sharded_runner``).  The kernel spins on its card
until every rank has joined, so its time holds this rank's lead over the
slowest.  Each rank reads its own trace (``per_rank``); rank 0 takes the
median of all their readings.

The kernel is found by its name as torch 2.11's profiler records it with
NCCL 2.28 on the H100: ``ncclDevKernel_AllReduce_Sum_u64_RING_LL`` (NCCL
runs the int64 MAX in that kernel).  The boundary's gathers
(``ncclDevKernel_AllGather``) and the broadcast that closes the window
(``ncclDevKernel_Broadcast``) are other kernels, and the barrier before
the window lies outside it."""

import statistics

KERNEL = "ncclDevKernel_AllReduce"


def per_rank(ctx):
    """This rank's all-reduce kernels that start inside the window, in
    ms."""
    return [(e.end - e.start) * 1e-6 for e in ctx.events
            if e.kind == "device" and e.name.startswith(KERNEL)
            and ctx.lo <= e.start < ctx.hi]


def read(ctx):
    d = [x for r in getattr(ctx, "per_rank", None) or [] for x in r or []]
    return statistics.median(d) if d else None
