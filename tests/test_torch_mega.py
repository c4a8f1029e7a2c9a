"""The port's fused Adam segment (plain torch version on the CPU) against
qoc_tpu's Pallas segment kernel (interpreted), with tests/test_mega.py's
problems and tolerances; plus segment composition, the convergence
freeze, the max_iterations predicate, carrying an optimizer state across
from qoc_tpu, and the per-iteration Adam runner."""

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
from qoc_tpu_torch.interop import adam_state_from_numpy, adam_state_to_numpy
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem
from qoc_tpu_torch.ops.mega import make_mega_segment_runner, mega_supported
from qoc_tpu_torch.optim.adam import init_adam_state, make_segment_runner

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


def test_fidelity_only_gate():
    _, tp = _problems("state")
    assert not mega_supported(tp, reg_coeffs={"amplitude": 0.1})
    assert not mega_supported(tp, gradient_mode="reference")
    with pytest.raises(NotImplementedError, match="costs"):
        make_mega_segment_runner(tp, _conv(), reg_coeffs={"dwdt": 0.01})


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
