"""The port's fused Adam segment (plain torch version on the CPU) against
qoc_tpu's Pallas segment kernel (interpreted), with tests/test_mega.py's
problems and tolerances, with and without penalties; plus segment
composition, the convergence freeze, the max_iterations predicate, the
admission gate and its fallback reasons, carrying an optimizer state
across from qoc_tpu, and the per-iteration Adam runner."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
from qoc_tpu.models.forward import make_forward as j_make_forward
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.optim.adam import (
    init_adam_state as j_init_adam,
    make_adam_optimizer,
    make_segment_runner as j_segment_runner,
)
from qoc_tpu.optim.convergence import ConvergenceSettings
from qoc_tpu.ops.pallas_mega import make_mega_segment_runner as j_mega_runner
from qoc_tpu.ops.pallas_mega import mega_state_to_optax
from qoc_tpu.ops.pallas_mega import mega_supported as j_mega_supported
from qoc_tpu.routing import fused_fallback_reasons as j_fallback_reasons
from qoc_tpu_torch.interop import adam_state_from_numpy, adam_state_to_numpy
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem
from qoc_tpu_torch.ops.mega import make_mega_segment_runner, mega_supported
from qoc_tpu_torch.optim.adam import init_adam_state, make_segment_runner
from qoc_tpu_torch.routing import fused_fallback_reasons

torch.set_num_threads(1)

N_ITERS = 20


def _state_args(steps=32):
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 2.0, steps,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[0.7, 0.7], seed=0))


def _unitary_args(steps=24):
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], q.SIGMA_X, 2.0, steps, [0, 1]),
            dict(maxA=[1.0, 1.0], seed=1, Taylor_terms=[6, 2]))


PROBLEMS = {"state": _state_args, "unitary": _unitary_args}


def _conv(**over):
    base = {"rate": 0.01, "update_step": 10, "max_iterations": 200,
            "conv_target": 1e-12}
    base.update(over)
    return ConvergenceSettings.from_dict(base)


def _problems(name):
    args, kwargs = PROBLEMS[name]()
    return (ControlProblem.build(*args, **kwargs),
            TorchProblem.build(*args, **kwargs))


@pytest.fixture(scope="module")
def qoc_tpu_segments():
    """qoc_tpu's segment kernel, N_ITERS iterations, per problem."""
    out = {}
    for name in PROBLEMS:
        jp, _ = _problems(name)
        init, run, unpad = j_mega_runner(jp, _conv())
        out[name] = (run(init(jp.u0_base), N_ITERS), unpad)
    return out


def _assert_matches(got, unpad_got, want, unpad_want):
    np.testing.assert_allclose(unpad_got(got.u_base),
                               np.asarray(unpad_want(want.u_base)),
                               atol=5e-5)
    np.testing.assert_allclose(got.loss, float(want.loss), atol=2e-5)
    np.testing.assert_allclose(got.grad_squared, float(want.grad_squared),
                               rtol=2e-3)
    np.testing.assert_allclose(got.unitary_scale, float(want.unitary_scale),
                               atol=1e-4)
    assert got.iteration == int(want.iteration)
    assert got.done == bool(want.done)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_segment_matches_qoc_tpu(name, qoc_tpu_segments):
    _, tp = _problems(name)
    assert mega_supported(tp)
    init, run, unpad = make_mega_segment_runner(tp, _conv())
    got = run(init(tp.u0_base), N_ITERS)
    want, unpad_want = qoc_tpu_segments[name]
    _assert_matches(got, unpad, want, unpad_want)
    np.testing.assert_allclose(got.lr, float(want.lr), rtol=1e-6)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_segments_compose(name):
    _, tp = _problems(name)
    init, run, _ = make_mega_segment_runner(tp, _conv())
    whole = run(init(tp.u0_base), N_ITERS)
    half = run(run(init(tp.u0_base), N_ITERS // 2), N_ITERS // 2)
    assert half.iteration == whole.iteration == N_ITERS
    np.testing.assert_allclose(half.u_base.numpy(), whole.u_base.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(half.loss, whole.loss, atol=1e-7)


def test_convergence_freezes_iterate():
    _, tp = _problems("state")
    init, run, unpad = make_mega_segment_runner(tp, _conv(conv_target=2.0))
    st = run(init(tp.u0_base), 10)
    assert st.done and st.iteration == 0
    np.testing.assert_array_equal(unpad(st.u_base), tp.u0_base)
    assert np.isfinite(st.loss)
    again = run(st, 5)                    # a frozen state stays frozen
    assert again.done and again.iteration == 0 and again.loss == st.loss


def test_max_iterations_predicate():
    _, tp = _problems("state")
    init, run, _ = make_mega_segment_runner(tp, _conv(max_iterations=7))
    st = run(init(tp.u0_base), 20)
    assert st.done and st.iteration == 7


GATE_CASES = {
    "none": None,
    "dwdt": {"dwdt": 0.01},
    "bandpass": {"bandpass": 0.1, "band": [0.1, 1.0]},
    "bandpass_without_band": {"bandpass": 0.1},
    "forbidden": {"forbidden_coeff_list": [1.0],
                  "states_forbidden_list": [1]},
    "speed_up": {"speed_up": 1.0},
    "unknown_key": {"amplitudes": 1.0},
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_mega_supported_matches_qoc_tpu(case):
    rc = GATE_CASES[case]
    for args, kwargs in (_state_args(), _unitary_args(),
                         _wide_args(9), _wide_args(17),
                         _state_args_no_inter()):
        jp = ControlProblem.build(*args, **kwargs)
        tp = TorchProblem.build(*args, **kwargs)
        for mode in ("exact", "reference"):
            assert mega_supported(tp, rc, mode) == j_mega_supported(
                jp, rc, mode), (args[5], kwargs, rc, mode)


@pytest.mark.parametrize("case", ["forbidden", "speed_up", "none"])
def test_fallback_reasons_match_qoc_tpu(case):
    rc = GATE_CASES[case]
    for args, kwargs in (_wide_args(9), _wide_args(17),
                         _state_args_no_inter()):
        jp = ControlProblem.build(*args, **kwargs)
        tp = TorchProblem.build(*args, **kwargs)
        for on_accel in (True, False):
            got = fused_fallback_reasons(tp, rc, "exact", on_accel=on_accel)
            want = j_fallback_reasons(jp, rc, "exact", on_accel=on_accel)
            assert len(got) == len(want), (got, want)
            assert any("V=" in r for r in got) == any("V=" in r
                                                       for r in want)
            assert any("use_inter_vecs" in r for r in got) == any(
                "use_inter_vecs" in r for r in want)


def _wide_args(V):
    """A state transfer with V concerned vectors (gate boundaries 8, 16)."""
    rng = np.random.default_rng(V)
    n = 6   # M = 12: inside the tree rule, so V alone decides
    vecs = [v / np.linalg.norm(v) for v in
            rng.standard_normal((2 * V, n)) + 1j * rng.standard_normal(
                (2 * V, n))]
    a = q.annihilate(n)
    return ((np.zeros((n, n), dtype=complex), [a + a.conj().T], ["x"],
             vecs[:V], 2.0, 16, vecs[V:]),
            dict(state_transfer=True, maxA=[0.5], seed=0))


def _state_args_no_inter():
    args, kwargs = _state_args()
    return args, dict(kwargs, use_inter_vecs=False)


# ---- the segment with penalties (tests/test_mega.py:100-394 cases) ----------


def _leakage_args(steps=32, state_transfer=True):
    """3-level ladder with a forbidden leakage level
    (tests/test_mega.py:78-96)."""
    n = 3
    a = q.annihilate(n)
    H0 = np.diag([0.0, 1.0, 1.95]) * 2 * np.pi
    ops = [a + a.conj().T, 1j * (a - a.conj().T)]
    if state_transfer:
        psi0 = np.zeros(n, complex)
        psi0[0] = 1
        tgt = np.zeros(n, complex)
        tgt[1] = 1
        return ((H0, ops, ["x", "y"], [tgt], 3.0, steps, [psi0]),
                dict(state_transfer=True, maxA=[0.5, 0.5], seed=0))
    return ((H0, ops, ["x", "y"], q.transmon_gate(q.SIGMA_X, n), 3.0, steps,
             [0, 1]), dict(maxA=[0.5, 0.5], seed=0))


def _dressed_args():
    H0 = np.array([[0.0, 0.05, 0.0], [0.05, 1.0, 0.05], [0.0, 0.05, 2.2]],
                  dtype=complex)
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    dinfo = {"eigenvectors": v_c, "eigenvalues": np.real(w_c),
             "dressed_id": dressed_id, "is_dressed": True}
    a = q.annihilate(3)
    return ((H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             q.transmon_gate(q.SIGMA_X, 3), 8.0, 48, [0, 1]),
            dict(dressed_info=dinfo, maxA=[2.0, 2.0], seed=0))


ALL_SEVEN = {"amplitude": 0.05, "envelope": 0.02, "dwdt": 0.001,
             "d2wdt2": 1e-7, "bandpass": 0.2, "band": [0.5, 2.0],
             "forbidden_coeff_list": [2.0], "states_forbidden_list": [2],
             "speed_up": 0.5}

COST_SEGMENTS = {
    # name: (problem args, reg_coeffs, iterations)
    "forbidden_state": (lambda: _leakage_args(), {
        "forbidden_coeff_list": [5.0], "states_forbidden_list": [2],
        "amplitude": 0.1}, 20),
    "forbidden_unitary": (lambda: _leakage_args(state_transfer=False), {
        "forbidden_coeff_list": [5.0], "states_forbidden_list": [2],
        "amplitude": 0.1}, 20),
    "forbid_dressed": (_dressed_args, {
        "forbidden_coeff_list": [5.0], "states_forbidden_list": [2],
        "forbid_dressed": True}, 15),
    "amplitude": (_state_args, {"amplitude": 0.2}, 20),
    "envelope": (_state_args, {"envelope": 0.3}, 20),
    "dwdt": (_state_args, {"dwdt": 0.005}, 20),
    "d2wdt2": (_state_args, {"d2wdt2": 1e-5}, 20),
    "pulse_all": (_state_args, {"amplitude": 0.1, "dwdt": 0.003,
                                "d2wdt2": 1e-6, "envelope": 0.05}, 20),
    "speed_up_state": (lambda: _leakage_args(), {
        "speed_up": 2.0, "amplitude": 0.05}, 20),
    "speed_up_unitary": (lambda: _leakage_args(state_transfer=False), {
        "speed_up": 2.0, "amplitude": 0.05}, 20),
    "bandpass_state": (lambda: _leakage_args(steps=40), {
        "bandpass": 0.5, "band": [0.5, 2.0]}, 20),
    "bandpass_unitary": (lambda: _leakage_args(40, state_transfer=False), {
        "bandpass": 0.5, "band": [0.5, 2.0]}, 20),
    "all_seven": (lambda: _leakage_args(40, state_transfer=False),
                  ALL_SEVEN, 15),
    "power_of_two_steps": (lambda: _state_args(steps=16), {"dwdt": 0.01},
                           10),
}


@pytest.mark.parametrize("name", list(COST_SEGMENTS))
def test_segment_with_costs_matches_qoc_tpu(name):
    make, rc, n = COST_SEGMENTS[name]
    args, kwargs = make()
    jp = ControlProblem.build(*args, **kwargs)
    tp = TorchProblem.build(*args, **kwargs)
    assert mega_supported(tp, reg_coeffs=rc) and j_mega_supported(
        jp, reg_coeffs=rc)
    j_init, j_run, j_unpad = j_mega_runner(jp, _conv(), reg_coeffs=rc)
    want = j_run(j_init(jp.u0_base), n)
    init, run, unpad = make_mega_segment_runner(tp, _conv(), reg_coeffs=rc)
    st = init(tp.u0_base)
    assert st.u_base.shape == tuple(np.shape(want.u_base))   # same Tp rule
    got = run(st, n)
    assert got.iteration == int(want.iteration) == n
    assert got.reg_loss - got.loss > 1e-4   # the penalties are on
    np.testing.assert_allclose(unpad(got.u_base),
                               np.asarray(j_unpad(want.u_base)), atol=5e-5)
    np.testing.assert_allclose(got.loss, float(want.loss), atol=2e-5)
    np.testing.assert_allclose(got.reg_loss, float(want.reg_loss), atol=2e-5)
    np.testing.assert_allclose(got.grad_squared, float(want.grad_squared),
                               rtol=2e-3)
    np.testing.assert_allclose(got.unitary_scale, float(want.unitary_scale),
                               atol=1e-4)


@pytest.mark.parametrize("rc", [None, ALL_SEVEN], ids=["fidelity", "costs"])
def test_segment_off_the_cpu_never_falls_back(rc):
    """A problem held off the CPU goes to the CUDA launchers, which refuse
    anything but CUDA float32 operands instead of running the plain
    version."""
    args, kwargs = _leakage_args(steps=40, state_transfer=False)
    tp = TorchProblem.build(*args, **kwargs)
    init, run, _ = make_mega_segment_runner(tp, _conv(), reg_coeffs=rc,
                                            device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        run(init(tp.u0_base), 5)


def test_costs_state_carries_across_from_qoc_tpu():
    """10 iterations with penalties in qoc_tpu, 10 more in the port == 20
    in qoc_tpu."""
    args, kwargs = _leakage_args(state_transfer=False)
    rc = ALL_SEVEN
    jp = ControlProblem.build(*args, **kwargs)
    tp = TorchProblem.build(*args, **kwargs)
    conv = _conv()
    j_init, j_run, j_unpad = j_mega_runner(jp, conv, reg_coeffs=rc)
    want = j_run(j_init(jp.u0_base), N_ITERS)
    half = j_run(j_init(jp.u0_base), N_ITERS // 2)
    u, opt = mega_state_to_optax(half, conv, jp.steps)
    init, run, unpad = make_mega_segment_runner(tp, conv, reg_coeffs=rc)
    Tp = init(tp.u0_base).u_base.shape[1]
    st = adam_state_from_numpy(np.asarray(u), np.asarray(opt[0].mu),
                               np.asarray(opt[0].nu), int(opt[0].count),
                               float(opt[1]["lr"]), tp.steps, Tp)
    got = run(st, N_ITERS // 2)
    assert got.iteration == N_ITERS
    np.testing.assert_allclose(unpad(got.u_base),
                               np.asarray(j_unpad(want.u_base)), atol=5e-5)
    np.testing.assert_allclose(got.reg_loss, float(want.reg_loss), atol=2e-5)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_state_carries_across_from_qoc_tpu(name, qoc_tpu_segments):
    """10 iterations in qoc_tpu, its optax layout into the port, 10 more
    in the port == qoc_tpu's 20."""
    jp, tp = _problems(name)
    conv = _conv()
    j_init, j_run, _ = j_mega_runner(jp, conv)
    half = j_run(j_init(jp.u0_base), N_ITERS // 2)
    u, opt = mega_state_to_optax(half, conv, jp.steps)
    adam, lr = opt[0], opt[1]["lr"]
    init, run, unpad = make_mega_segment_runner(tp, conv)
    Tp = init(tp.u0_base).u_base.shape[1]
    st = adam_state_from_numpy(np.asarray(u), np.asarray(adam.mu),
                               np.asarray(adam.nu), int(adam.count),
                               float(lr), tp.steps, Tp)
    assert st.iteration == N_ITERS // 2
    got = run(st, N_ITERS // 2)
    want, unpad_want = qoc_tpu_segments[name]
    _assert_matches(got, unpad, want, unpad_want)

    back = adam_state_to_numpy(got, tp.steps)
    np.testing.assert_array_equal(back[0], unpad(got.u_base))
    assert back[3] == N_ITERS


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_adam_runner_matches_qoc_tpu(name):
    """The per-iteration runner on the scan engine against qoc_tpu's optax
    segment runner on its scan engine."""
    jp, tp = _problems(name)
    conv = _conv()
    _, j_loss = j_make_forward(jp, lean=True, engine="scan")
    opt = make_adam_optimizer(conv)
    j_run, _ = j_segment_runner(j_loss, conv, opt)
    want = j_run(j_init_adam(jp.u0_base, opt),
                 jnp.asarray(N_ITERS, dtype=jnp.int32))
    _, loss_fn = make_forward(tp, lean=True, engine="scan")
    run = make_segment_runner(loss_fn, conv)
    got = run(init_adam_state(torch.tensor(tp.u0_base), conv), N_ITERS)
    assert got.iteration == int(want.iteration) == N_ITERS
    np.testing.assert_allclose(got.u_base.numpy(), np.asarray(want.u_base),
                               atol=5e-5)
    np.testing.assert_allclose(got.loss, float(want.loss), atol=2e-5)
    np.testing.assert_allclose(got.grad_squared, float(want.grad_squared),
                               rtol=2e-3)
    np.testing.assert_allclose(got.unitary_scale, float(want.unitary_scale),
                               atol=1e-4)
