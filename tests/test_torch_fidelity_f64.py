"""The float64 fidelity readout's batched path (``fidelity_f64(...,
device=)``, run here with ``device="cpu"``) against its numpy host loop
(``device=None``), to 1e-12 absolute: a state transfer, config 3's gate
from a non-identity U0, steps whose scaling exponents differ, an odd
number of steps, chunks of steps, and the float32 iso targets.  On the
CPU ``Grape`` keeps the host loop, bit for bit."""

import dataclasses

import numpy as np
import pytest
import scipy.linalg
import torch

import qoc_tpu_torch as qt
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.utils import analysis
from qoc_tpu_torch.utils.analysis import fidelity_f64, uks_from_base

torch.set_num_threads(1)

ATOL = 1e-12


def _pi_pulse():
    problem = ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [qt.SIGMA_X, qt.SIGMA_Y],
        ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 64,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[2 * np.pi * 0.1] * 2, seed=1)
    return problem, uks_from_base(problem, problem.u0_base)


def _config3_gate():
    """BASELINE config 3's 5-level X gate (V = 2), from a random U0."""
    levels = 5
    a = qt.annihilate(levels)
    ad = a.conj().T
    rng = np.random.default_rng(3)
    h = rng.normal(size=(levels, levels)) + 1j * rng.normal(
        size=(levels, levels))
    U0 = scipy.linalg.expm(-0.5j * (h + h.conj().T))
    problem = ControlProblem.build(
        (-0.2 * 2 * np.pi / 2) * (ad @ ad @ a @ a), [a + ad, 1j * (a - ad)],
        ["x", "y"], qt.transmon_gate(qt.SIGMA_X, levels), 6.0, 300, [0, 1],
        U0=U0, maxA=[2.0, 2.0], seed=2)
    return problem, uks_from_base(problem, problem.u0_base)


def _mixed_scaling(steps=12):
    """A 4-level state transfer whose pulses ramp from 0 (a zero
    generator: s = 0) to where ||A||_F needs s >= 2."""
    rng = np.random.default_rng(5)

    def herm():
        h = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
        return (h + h.conj().T) / 2

    psi0 = np.array([1, 0, 0, 0], dtype=complex)
    tgt = np.array([0, 0, 1, 0], dtype=complex)
    problem = ControlProblem.build(
        np.zeros((4, 4), dtype=complex), [herm(), herm()], ["a", "b"],
        [tgt], 2.0 * steps, steps, [psi0], state_transfer=True,
        maxA=[3.0, 3.0], seed=0)
    uks = np.stack([np.linspace(0.0, 3.0, steps),
                    np.linspace(0.0, -2.5, steps)])
    return problem, uks


def _scalings(problem, uks) -> list:
    """Each step's s by the host loop's rule."""
    H0 = np.asarray(problem.H0_c)
    out = []
    for t in range(problem.steps):
        A = -1j * problem.dt * (H0 + sum(
            u * np.asarray(H) for u, H in zip(uks[:, t], problem.ops_c)))
        out.append(max(0, int(np.ceil(np.log2(max(
            np.linalg.norm(A, "fro"), 1e-30))))))
    return out


def _odd_steps():
    return _mixed_scaling(steps=13)


def _iso_targets():
    problem, uks = _config3_gate()
    return dataclasses.replace(problem, U_c=None), uks


CASES = {
    "pi_pulse": (_pi_pulse, None),
    "config3_gate": (_config3_gate, None),
    "mixed_scaling": (_mixed_scaling, None),
    "odd_steps": (_odd_steps, None),
    # 3 steps a chunk: 13 steps cross 5 chunks, each with an odd leftover
    "chunked": (_odd_steps, 3),
    "iso_targets": (_iso_targets, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_path_matches_the_host_loop(case, monkeypatch):
    make, chunk_steps = CASES[case]
    problem, uks = make()
    if chunk_steps is not None:
        n = problem.state_num
        monkeypatch.setattr(analysis, "_CHUNK_BYTES", 16 * n * n * chunk_steps)
        assert -(-problem.steps // chunk_steps) >= 3
    if case == "mixed_scaling":
        s = _scalings(problem, uks)
        assert min(s) == 0 and max(s) >= 2 and len(set(s)) >= 3, s
    if case == "odd_steps":
        assert problem.steps % 2 == 1
    host = fidelity_f64(problem, uks)
    batched = fidelity_f64(problem, uks, device="cpu")
    assert isinstance(batched, float)
    assert abs(batched - host) <= ATOL, (batched, host)
    assert 1e-6 < host < 1.0 + 1e-12  # neither a trivial nor a broken chain


def test_grape_on_the_cpu_reports_the_host_loop():
    args = (np.zeros((2, 2), dtype=complex), [qt.SIGMA_X, qt.SIGMA_Y],
            ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 32,
            [np.array([1, 0], dtype=complex)])
    res = qt.Grape(*args, state_transfer=True, maxA=[2 * np.pi * 0.1] * 2,
                   seed=0, save=False, show_plots=False, device="cpu",
                   convergence={"rate": 0.01, "update_step": 5,
                                "max_iterations": 10, "conv_target": 1e-12})
    assert res.fidelity_f64 == fidelity_f64(res.problem, res.uks)
