"""The fused multi-iteration optimizer kernels on the card (the
counterpart of tests_tpu/test_mega_on_tpu.py, test for test, at its
tolerances).

Kernel 3 (``ops.mega``, one problem's Adam segments on a thread-block
cluster) and kernel 6 (``parallel.mega_batch``, many seeds' segments with
per-seed freezing) run whole multi-iteration trajectories, compared with
the port's per-iteration segment runner over the scan engine on the same
card.
"""

import numpy as np
import pytest

from conftest import gap, launches, on, state_problem, unitary_problem

import qoc_tpu_torch as q
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.ops.mega import make_mega_segment_runner, mega_supported
from qoc_tpu_torch.optim.adam import init_adam_state, make_segment_runner
from qoc_tpu_torch.optim.convergence import ConvergenceSettings
from qoc_tpu_torch.parallel.mega_batch import (batched_mega_supported,
                                               make_mega_batched_runner)

pytestmark = pytest.mark.gpu


def _conv(**over):
    base = {"rate": 0.01, "update_step": 10, "max_iterations": 500,
            "conv_target": 1e-12}
    base.update(over)
    return ConvergenceSettings.from_dict(base)


def _run_xla(problem, conv, n, device, reg_coeffs=None, u0=None):
    """n iterations of the per-iteration Adam over the scan engine."""
    _, loss_fn = make_forward(problem, lean=True, engine="scan",
                              reg_coeffs=reg_coeffs, device=device)
    run_seg = make_segment_runner(loss_fn, conv)
    st = init_adam_state(on(device, problem.u0_base if u0 is None else u0),
                         conv)
    return run_seg(st, n)


def _host(x):
    return x.detach().cpu().numpy()


def _forbidden_problem():
    n = 3
    a = q.annihilate(n)
    H0 = np.diag([0.0, 1.0, 1.95]) * 2 * np.pi
    psi0 = np.zeros(n, complex)
    psi0[0] = 1
    tgt = np.zeros(n, complex)
    tgt[1] = 1
    return ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        3.0, 64, [psi0], state_transfer=True, maxA=[0.5, 0.5], seed=0)


def test_mega_state_transfer_trajectory_on_gpu(device, record_property):
    problem = state_problem(steps=64)
    conv = _conv()
    assert mega_supported(problem)
    ref = _run_xla(problem, conv, 30, device)
    init_state, run_segment, unpad = make_mega_segment_runner(
        problem, conv, device=device)
    with launches(device, "mega_segment"):
        ms = run_segment(init_state(problem.u0_base), 30)
    assert int(ms.iteration) == 30
    record_property("u_gap", gap(unpad(ms.u_base), _host(ref.u_base)))
    record_property("loss_gap", abs(ms.loss - ref.loss))
    record_property("grad_squared_rel_gap",
                    abs(ms.grad_squared / ref.grad_squared - 1.0))
    np.testing.assert_allclose(unpad(ms.u_base), _host(ref.u_base),
                               atol=5e-5)
    np.testing.assert_allclose(ms.loss, ref.loss, atol=2e-5)
    np.testing.assert_allclose(ms.grad_squared, ref.grad_squared, rtol=2e-3)


def test_mega_unitary_with_penalties_on_gpu(device, record_property):
    problem = unitary_problem(steps=24)
    rc = {"amplitude": 0.1, "dwdt": 0.003}
    conv = _conv()
    ref = _run_xla(problem, conv, 20, device, reg_coeffs=rc)
    init_state, run_segment, unpad = make_mega_segment_runner(
        problem, conv, reg_coeffs=rc, device=device)
    with launches(device, "mega_segment_costs"):
        ms = run_segment(init_state(problem.u0_base), 20)
    record_property("u_gap", gap(unpad(ms.u_base), _host(ref.u_base)))
    record_property("reg_loss_gap", abs(ms.reg_loss - ref.reg_loss))
    record_property("unitary_scale_gap",
                    abs(ms.unitary_scale - ref.unitary_scale))
    np.testing.assert_allclose(unpad(ms.u_base), _host(ref.u_base),
                               atol=8e-5)
    np.testing.assert_allclose(ms.reg_loss, ref.reg_loss, atol=2e-5)
    np.testing.assert_allclose(ms.unitary_scale, ref.unitary_scale,
                               atol=1e-4)


def test_mega_batch_per_seed_trajectories_on_gpu(device, record_property):
    """4 independent seeds through the batched kernel == 4 individual
    per-iteration trajectories (the per-seed blocks, the freeze flags and
    the group sums against the op-per-op Adam on the card)."""
    problem = state_problem(steps=64)
    conv = _conv()
    assert batched_mega_supported(problem)
    rng = np.random.default_rng(11)
    S = 4
    u0s = rng.normal(
        scale=1.0 / np.sqrt(problem.steps),
        size=(S, problem.ops_len, problem.steps)).astype(np.float32)

    init_state, run_n, read_u = make_mega_batched_runner(problem, conv,
                                                         device=device)
    with launches(device, "mega_batch_segment"):
        st = run_n(init_state(u0s), 25)
    u_batch = read_u(st)
    losses = _host(st.losses)

    refs = [_run_xla(problem, conv, 25, device, u0=u0s[s]) for s in range(S)]
    record_property("u_gap", max(gap(u_batch[s], _host(r.u_base))
                                 for s, r in enumerate(refs)))
    record_property("loss_gap", gap(losses, [r.loss for r in refs]))
    for s, ref in enumerate(refs):
        np.testing.assert_allclose(
            u_batch[s], _host(ref.u_base), atol=1e-4,
            err_msg=f"seed {s} diverged from the per-iteration trajectory")
        np.testing.assert_allclose(losses[s], ref.loss, atol=2e-5)


def test_mega_batch_convergence_freezing_on_gpu(device, record_property):
    """Per-seed freezing: with an immediately-satisfied target no seed
    advances (the state round-trips unchanged)."""
    problem = state_problem(steps=64)
    conv = _conv(conv_target=2.0)
    rng = np.random.default_rng(5)
    u0s = rng.normal(
        scale=0.1, size=(2, problem.ops_len, problem.steps)
    ).astype(np.float32)
    init_state, run_n, read_u = make_mega_batched_runner(problem, conv,
                                                         device=device)
    with launches(device, "mega_batch_segment"):
        st = run_n(init_state(u0s), 10)
    record_property("u_gap", gap(read_u(st), u0s))
    np.testing.assert_array_equal(read_u(st), u0s)
    assert np.all(_host(st.it_cols) == 0.0)


def test_forbidden_scan_kernel_on_gpu(device, record_property):
    """Forbidden-state costs inside kernel 3's costs instance (the
    trajectory's prefix products and the cotangent injection)."""
    problem = _forbidden_problem()
    rc = {"forbidden_coeff_list": [5.0], "states_forbidden_list": [2],
          "amplitude": 0.1}
    conv = _conv()
    assert mega_supported(problem, rc)
    ref = _run_xla(problem, conv, 20, device, reg_coeffs=rc)
    init_state, run_segment, unpad = make_mega_segment_runner(
        problem, conv, reg_coeffs=rc, device=device)
    with launches(device, "mega_segment_costs"):
        ms = run_segment(init_state(problem.u0_base), 20)
    record_property("u_gap", gap(unpad(ms.u_base), _host(ref.u_base)))
    record_property("reg_loss_gap", abs(ms.reg_loss - ref.reg_loss))
    record_property("loss_gap", abs(ms.loss - ref.loss))
    np.testing.assert_allclose(unpad(ms.u_base), _host(ref.u_base),
                               atol=8e-5)
    np.testing.assert_allclose(ms.reg_loss, ref.reg_loss, atol=2e-5)
    np.testing.assert_allclose(ms.loss, ref.loss, atol=2e-5)


def test_forbidden_batched_kernel_on_gpu(device, record_property):
    """Forbidden-state cotangent injection in the batched kernel's costs
    instance."""
    problem = _forbidden_problem()
    rc = {"forbidden_coeff_list": [4.0], "states_forbidden_list": [2]}
    conv = _conv()
    assert batched_mega_supported(problem, rc)
    rng = np.random.default_rng(3)
    S = 2
    u0s = rng.normal(scale=1.0 / np.sqrt(problem.steps),
                     size=(S, problem.ops_len, problem.steps)
                     ).astype(np.float32)
    init_state, run_n, read_u = make_mega_batched_runner(
        problem, conv, reg_coeffs=rc, device=device)
    with launches(device, "mega_batch_segment_costs"):
        st = run_n(init_state(u0s), 12)
    ub = read_u(st)
    reg_losses = _host(st.reg_losses)
    refs = [_run_xla(problem, conv, 12, device, reg_coeffs=rc, u0=u0s[s])
            for s in range(S)]
    record_property("u_gap", max(gap(ub[s], _host(r.u_base))
                                 for s, r in enumerate(refs)))
    record_property("reg_loss_gap",
                    gap(reg_losses, [r.reg_loss for r in refs]))
    for s, ref in enumerate(refs):
        np.testing.assert_allclose(ub[s], _host(ref.u_base), atol=8e-5)
        np.testing.assert_allclose(reg_losses[s], ref.reg_loss, atol=2e-5)
