"""enqueue_ms (``.single`` and ``.batch``): the host's ms an iteration of
a per-iteration runner spends issuing work inside the traced window: the
summed durations of the ``qoc.step.grad`` spans (the value and gradient,
forward and backward enqueued) and ``qoc.step.update`` spans (the Adam
step; in the batch layer with the predicates and the masked update),
over the count of ``qoc.step.grad`` spans.  The reads in between
(``qoc.step.read``), where the host waits for the card, are left out.

The value is host time under the profiler, which adds some 10-30 us to
each operator enqueued: it reads well above the untraced enqueue, and
falls faster than the untraced enqueue when an operator goes.  Compare
it only between traced runs, with the operator count."""

from benchmark import trace


def read(ctx):
    def inside(name):
        return [t - s for s, t in trace.spans(ctx.events, name)
                if ctx.lo <= s and t <= ctx.hi]

    grads = inside("qoc.step.grad")
    if not grads:
        return None
    return (sum(grads) + sum(inside("qoc.step.update"))) / len(grads) * 1e-6
