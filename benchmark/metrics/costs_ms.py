"""costs_ms (``.single``): the host's ms an iteration spends enqueuing
the eager costs in the traced window: the summed durations of the
``qoc.costs`` spans (``total_reg_cost`` in the forward: dwdt, the
bandpass FFTs, speed_up over the trajectory; their backward runs later,
outside the span), over the count of ``qoc.step.grad`` spans.  A
solve's readout forward adds one span, outside any ``qoc.step.grad``;
it is counted too.

Host time under the profiler, as ``enqueue_ms`` is: compare it only
between traced runs.  None where the program records no such span (the
costs inside a fused kernel, or a program without the span)."""

from benchmark import trace


def read(ctx):
    def inside(name):
        return [t - s for s, t in trace.spans(ctx.events, name)
                if ctx.lo <= s and t <= ctx.hi]

    grads, costs = inside("qoc.step.grad"), inside("qoc.costs")
    if not grads or not costs:
        return None
    return sum(costs) / len(grads) * 1e-6
