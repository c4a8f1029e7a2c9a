"""sweep_ms (``.single``): the host's ms an iteration spends inside the
pscan engine's serial sweeps in the traced window: the summed durations
of the ``qoc.pscan.sweep`` spans (the forward sweep, one [M, M] @ [M, V]
product a step) and ``qoc.pscan.reverse`` spans (the adjoint sweep, in
the backward, on whichever thread autograd runs it), over the count of
``qoc.step.grad`` spans.  A solve's readout sweeps once more, outside
any ``qoc.step.grad``; it is counted too.

The value is host time under the profiler, as ``enqueue_ms`` is: each
product enqueued costs some 10-30 us more than untraced.  Compare it
only between traced runs.  None where the program records no such span
(an engine other than pscan, or a program without the spans)."""

from benchmark import trace


def read(ctx):
    def inside(name):
        return [t - s for s, t in trace.spans(ctx.events, name)
                if ctx.lo <= s and t <= ctx.hi]

    grads = inside("qoc.step.grad")
    sweeps = inside("qoc.pscan.sweep") + inside("qoc.pscan.reverse")
    if not grads or not sweeps:
        return None
    return sum(sweeps) / len(grads) * 1e-6
