"""The program's launch spans and the card's kernels on one clock (no
tests_tpu counterpart: qoc_tpu records no spans).

In a traced ``Grape`` call on config 3 (kernel 3's costs instance) and a
traced kernel 6 batch of config 3, every launch call of the kernel lies
inside one ``prepare`` span of its runner, and the kernel starts on the
card after its own launch call started (so after the span started), by
the profiler's one clock.  The kernels' plain versions launch nothing,
so the test is the card's only.

The profiler maps the card's timestamps onto the host's clock.  On an
H100 every kernel of three traced processes started 4.5-91 us after its
own launch call; two other runs read a kernel's start 53 and 63 us
before its span's start.  ``CLOCK_SLACK_NS`` allows about three times
that lead before the kernel's own launch call; an offset of the order
of the idle gaps the benchmark charges to spans (0.2-0.8 ms), or kernels
on a clock of their own, fail.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import launches

import qoc_tpu_torch as q
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.parallel.batch import batched_grape_adam

pytestmark = pytest.mark.gpu

REG = {"forbidden_coeff_list": [10.0, 10.0, 10.0],
       "states_forbidden_list": [2, 3, 4], "dwdt": 0.001}
CONV = {"rate": 0.02, "update_step": 50, "max_iterations": 100,
        "conv_target": 1e-12}
CLOCK_SLACK_NS = 200_000


def _config3():
    levels = 5
    a = q.annihilate(levels)
    ad = a.conj().T
    H0 = (-0.2 * 2 * np.pi / 2) * (ad @ ad @ a @ a)
    return (H0, [a + ad, 1j * (a - ad)], ["x", "y"],
            q.transmon_gate(q.SIGMA_X, levels), 6.0, 300, [0, 1])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return list(prof.profiler.kineto_results.events())


def _on_card(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _launch_checks(events, kernel: str, span: str):
    """Each device kernel whose name holds ``kernel``: its launch call
    (the host runtime event of the same correlation id) inside exactly
    one host ``span``.  Returns how many kernels were checked, and the
    most ns a kernel's start read before its span's start and before
    its own launch call's start (0 where none did)."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if e.name() == span and not _on_card(e))
    calls = {e.correlation_id(): e for e in events
             if not _on_card(e) and e.name().startswith("cu")
             and "Launch" in e.name()}
    kernels = [e for e in events if _on_card(e) and kernel in e.name()]
    assert kernels and len(spans) == len(kernels), (len(spans), len(kernels))
    span_lead = call_lead = 0
    for k in kernels:
        call = calls[k.correlation_id()]
        lo, hi = call.start_ns(), call.start_ns() + call.duration_ns()
        around = [s for s in spans if s[0] <= lo and hi <= s[1]]
        assert len(around) == 1, (k.name(), lo, spans)
        span_lead = max(span_lead, around[0][0] - k.start_ns())
        call_lead = max(call_lead, lo - k.start_ns())
    return len(kernels), span_lead, call_lead


def test_launch_spans_share_the_card_clock_on_gpu(device, record_property):
    if device.type != "cuda":
        pytest.skip("the launch spans exist on the card only: the plain "
                    "versions launch nothing")
    args = _config3()
    with launches(device, "mega_segment_costs", "mega_batch_segment_costs"):
        grape = _traced(lambda: q.Grape(
            *args, convergence=CONV, reg_coeffs=REG, maxA=[2.0, 2.0],
            seed=0, method="Adam", show_plots=False, save=False,
            device=device))
        problem = ControlProblem.build(*args, maxA=[2.0, 2.0], seed=0)
        batch = _traced(lambda: batched_grape_adam(
            problem, n_seeds=64, convergence=CONV, reg_coeffs=REG, seed=1,
            device=device))
    n3, span3, call3 = _launch_checks(grape, "mega_segment_kernel",
                                      "qoc.mega.prepare")
    n6, span6, call6 = _launch_checks(batch, "mega_batch_kernel",
                                      "qoc.mega_batch.prepare")
    record_property("kernel3_launches", n3)
    record_property("kernel6_launches", n6)
    record_property("kernel_span_lead_ns", max(span3, span6))
    record_property("kernel_call_lead_ns", max(call3, call6))
    assert max(call3, call6) <= CLOCK_SLACK_NS, (call3, call6)
