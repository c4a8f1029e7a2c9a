"""The float64 fidelity readout on the card (no tests_tpu counterpart:
qoc_tpu computes it on the host, a TPU having no float64).

``fidelity_f64(..., device=card)`` runs the host loop's Taylor
polynomial, scaling and squaring as batched complex128 matrices; it is
held against the numpy host loop (``device=None``) to 1e-10 at BASELINE
config 5's dim-200 cavity (200 steps, scaling exponent 4) with random
pulses, and at config 3's 5-level gate.  Each case records both wall
times.  A ``Grape`` solve on the card enters the batched readout's span
once, inside its ``qoc.grape.fidelity_f64`` span.  The CPU switch skips
these tests: at dim 200 the host loop alone takes seconds there.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qoc_tpu_torch as q
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.utils.analysis import fidelity_f64, uks_from_base

pytestmark = pytest.mark.gpu

ATOL = 1e-10


def _cavity_dim200():
    """BASELINE config 5: qubit x 100-level cavity, |g,0> -> |e,0>."""
    nc = 100
    a = np.kron(np.eye(2), np.diag(np.sqrt(np.arange(1, nc)), 1))
    sm = np.kron(np.array([[0, 1], [0, 0]]), np.eye(nc))
    H0 = (2 * np.pi * 0.1 * (a.conj().T @ a)
          + 2 * np.pi * 0.05 * (a.conj().T @ sm + a @ sm.conj().T))
    Hops = [sm + sm.conj().T, 1j * (sm - sm.conj().T), a + a.conj().T]
    psi0 = np.zeros(2 * nc, complex)
    psi0[0] = 1
    tgt = np.zeros(2 * nc, complex)
    tgt[nc] = 1
    return (H0, Hops, ["x", "y", "c"], [tgt], 4.0, 200, [psi0]), dict(
        state_transfer=True, maxA=[2 * np.pi * 0.3] * 3)


def _config3():
    levels = 5
    a = q.annihilate(levels)
    ad = a.conj().T
    H0 = (-0.2 * 2 * np.pi / 2) * (ad @ ad @ a @ a)
    return (H0, [a + ad, 1j * (a - ad)], ["x", "y"],
            q.transmon_gate(q.SIGMA_X, levels), 6.0, 300, [0, 1]), dict(
        maxA=[2.0, 2.0])


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


@pytest.mark.parametrize("system", [_cavity_dim200, _config3],
                         ids=["config5_dim200", "config3"])
def test_fidelity_readout_matches_the_host_loop_on_gpu(device, rng, system,
                                                       record_property):
    if device.type != "cuda":
        pytest.skip("the batched readout's CPU run is tier-1's "
                    "(tests/test_torch_fidelity_f64.py)")
    args, kwargs = system()
    problem = ControlProblem.build(*args, seed=0, **kwargs)
    uks = uks_from_base(problem, rng.normal(
        0.0, 1.0, (problem.ops_len, problem.steps)))
    fidelity_f64(problem, uks, device=device)  # cuBLAS's first complex128
    card, card_s = _timed(lambda: fidelity_f64(problem, uks, device=device))
    host, host_s = _timed(lambda: fidelity_f64(problem, uks))
    record_property("fidelity_f64_gap", abs(card - host))
    record_property("card_s", card_s)
    record_property("host_s", host_s)
    assert abs(card - host) < ATOL, (card, host)


def test_grape_reads_its_fidelity_on_the_card_on_gpu(device, record_property):
    if device.type != "cuda":
        pytest.skip("Grape takes the host loop off the card")
    args, kwargs = _config3()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = q.Grape(*args, seed=0, method="Adam", show_plots=False,
                      save=False, device=device,
                      convergence={"rate": 0.02, "update_step": 50,
                                   "max_iterations": 100,
                                   "conv_target": 1e-12}, **kwargs)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        spans.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    card = spans.get("qoc.analysis.fidelity_f64_card", [])
    outer = spans["qoc.grape.fidelity_f64"]
    assert len(card) == 1 and len(outer) == 1, (card, outer)
    assert outer[0][0] <= card[0][0] and card[0][1] <= outer[0][1]
    host = fidelity_f64(res.problem, res.uks)
    record_property("fidelity_f64_gap", abs(res.fidelity_f64 - host))
    assert abs(res.fidelity_f64 - host) < ATOL, (res.fidelity_f64, host)
