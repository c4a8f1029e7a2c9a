"""Remat in the port's batch layer against qoc_tpu on the CPU: the
column-batched loss with ``remat=True`` (qoc_tpu's default) against
``remat=False`` and against qoc_tpu's loss; ``make_batched_runner(
remat=True, backend="xla")`` (``torch.func.vmap(grad)`` through
``ops.remat.recompute``) against qoc_tpu's on state-transfer and unitary
problems; and the recompute Function itself under ``torch.func``.
Inputs are made with numpy from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu.parallel.batch as jbatch
import qoc_tpu_torch as qt
from qoc_tpu.optim.convergence import ConvergenceSettings as JConv
from qoc_tpu.parallel.xla_batch import make_xla_batched_loss as j_cols_loss
from qoc_tpu_torch.optim.convergence import ConvergenceSettings as TConv
from qoc_tpu_torch.ops.remat import recompute
from qoc_tpu_torch.parallel.batch import make_batched_runner
from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss

torch.set_num_threads(1)

N_ITERS = 5
CONV = {"rate": 0.05, "update_step": 10, "max_iterations": 100,
        "conv_target": 1e-12}


def _leakage(m, levels=5, steps=12):
    a = m.annihilate(levels)
    return m.ControlProblem.build(
        np.diag(np.arange(levels) * 1.0) * 2 * np.pi
        - 2 * np.pi * 0.05 * np.diag(np.arange(levels) ** 2 * 1.0),
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        [np.eye(levels)[1].astype(complex)], 2.0, steps,
        [np.eye(levels)[0].astype(complex)],
        state_transfer=True, maxA=[0.5, 0.5], seed=0)


def _gate_u0(m):
    a = m.annihilate(3)
    U0, _ = np.linalg.qr(np.eye(3) - 0.4j * (a + a.conj().T))
    return m.ControlProblem.build(
        np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        m.transmon_gate(m.SIGMA_X, 3), 3.0, 12, [0], maxA=[0.6, 0.6],
        seed=0, Taylor_terms=[8, 2], U0=U0)


def _gate(m):
    a = m.annihilate(3)
    return m.ControlProblem.build(
        np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        m.transmon_gate(m.SIGMA_X, 3), 3.0, 12, [0, 1], maxA=[0.6, 0.6],
        seed=0, Taylor_terms=[8, 2])


def _pi(m):
    return m.ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [m.SIGMA_X, m.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 2.0, 16,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0)


def _u0(p, S, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, p.ops_len, p.steps))
            / np.sqrt(p.steps)).astype(np.float32)


# name: (problem, reg_coeffs, extra channel, (fid/reg atol, grad atol)
# against qoc_tpu) -- tests/test_torch_batch.py's LOSSES
LOSSES = {
    "extras_reg": (_leakage, {"amplitude": 0.1, "dwdt": 0.01}, True,
                   (1e-5, 2e-5)),
    "forbidden": (_leakage, {"forbidden_coeff_list": [6.0, 3.0],
                             "states_forbidden_list": [2, 3],
                             "amplitude": 0.05}, False, (1e-5, 2e-5)),
    "speed_up_state": (_leakage, {"speed_up": 0.05, "amplitude": 0.02},
                       False, (1e-4, 2e-4)),
    "speed_up_unitary": (_gate_u0, {"speed_up": 0.1}, False, (1e-4, 2e-4)),
    "unitary_scaling": (_gate_u0, None, False, (1e-5, 2e-5)),
}


def _extra(p, S):
    em = np.stack([np.asarray(q.c_to_r_mat(-1j * p.dt * np.diag(
        np.arange(p.state_num, dtype=float))))]).astype(np.float32)
    return em, np.linspace(-0.2, 0.2, S)[:, None].astype(np.float32)


def _port_loss_and_grad(tp, rc, em, ew, u, remat):
    loss = make_xla_batched_loss(tp, rc, extra_channel_mats=em, remat=remat)
    x = torch.tensor(u, requires_grad=True)
    reg, fid = loss(x, None if ew is None else torch.tensor(ew))
    (g,) = torch.autograd.grad(reg.sum(), x)
    return reg.detach().numpy(), fid.detach().numpy(), g.numpy()


@pytest.mark.parametrize("name", list(LOSSES))
def test_cols_loss_remat_matches_no_remat_and_qoc_tpu(name):
    """remat changes only what the backward pass keeps: the same reg and
    fidelity losses bit for bit (the forward is the same ops) and the
    gradient within rel 1e-6 of remat=False; and qoc_tpu's default
    (remat=True) within tests/test_torch_batch.py's bars (1e-5 on values,
    2e-5 on gradients; 1e-4 and 2e-4 with speed_up)."""
    make, rc, extra, (tol, gtol) = LOSSES[name]
    jp, tp = make(q), make(qt)
    S = 3
    u = _u0(jp, S)
    em, ew = _extra(jp, S) if extra else (None, None)
    reg1, fid1, g1 = _port_loss_and_grad(tp, rc, em, ew, u, remat=True)
    reg0, fid0, g0 = _port_loss_and_grad(tp, rc, em, ew, u, remat=False)
    np.testing.assert_array_equal(reg1, reg0)
    np.testing.assert_array_equal(fid1, fid0)
    np.testing.assert_allclose(g1, g0, rtol=0, atol=1e-6 * np.abs(g0).max())

    jl = j_cols_loss(jp, rc, extra_channel_mats=em)
    jew = None if ew is None else jnp.asarray(ew)
    jreg, jfid = jl(jnp.asarray(u), jew)
    jg = jax.grad(lambda x: jnp.sum(jl(x, jew)[0]))(jnp.asarray(u))
    np.testing.assert_allclose(reg1, np.asarray(jreg), atol=tol)
    np.testing.assert_allclose(fid1, np.asarray(jfid), atol=tol)
    np.testing.assert_allclose(g1, np.asarray(jg), atol=gtol)


# name: (problem, reg_coeffs)
RUNS = {
    "state_transfer": (_pi, {"amplitude": 0.1}),
    "state_transfer_speed_up": (_leakage, {"speed_up": 0.05}),
    "unitary": (_gate, {"amplitude": 0.1}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_xla_backend_remat_matches_qoc_tpu(name):
    """make_batched_runner(remat=True, backend="xla"), 5 iterations from
    the same pulses: qoc_tpu's remat runner within tests/test_torch_
    batch.py's bars (u 5e-5, losses 2e-5, grad^2 rel 2e-3), and the
    port's own remat=False run within 1e-6 (the same arithmetic, the
    steps recomputed in the backward pass)."""
    make, rc = RUNS[name]
    jp, tp = make(q), make(qt)
    u0 = _u0(jp, 3, seed=4)
    ji, jr = jbatch.make_batched_runner(jp, JConv.from_dict(CONV),
                                        reg_coeffs=rc, remat=True,
                                        backend="xla")
    want = jr(ji(jnp.asarray(u0)), jnp.asarray(N_ITERS, jnp.int32), None)
    got = {}
    for remat in (True, False):
        ti, tr = make_batched_runner(tp, TConv.from_dict(CONV),
                                     reg_coeffs=rc, remat=remat,
                                     backend="xla", device="cpu")
        got[remat] = tr(ti(u0), N_ITERS, None)
    s = got[True]
    assert s.iteration == int(want.iteration) == N_ITERS
    np.testing.assert_allclose(s.u_base.numpy(), np.asarray(want.u_base),
                               atol=5e-5)
    np.testing.assert_allclose(s.loss.numpy(), np.asarray(want.loss),
                               atol=2e-5)
    np.testing.assert_allclose(s.reg_loss.numpy(),
                               np.asarray(want.reg_loss), atol=2e-5)
    np.testing.assert_allclose(s.grad_squared.numpy(),
                               np.asarray(want.grad_squared), rtol=2e-3)
    for f in ("u_base", "loss", "reg_loss"):
        np.testing.assert_allclose(getattr(s, f).numpy(),
                                   getattr(got[False], f).numpy(), rtol=0,
                                   atol=1e-6)


def test_recompute_under_vmap_grad():
    """recompute(fn, ...) under torch.func.vmap(grad_and_value) and under
    plain autograd gives the values and gradients of fn itself, bit for
    bit, for a tuple-valued step chained over time (float64)."""
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((3, 4, 4)) * 0.3)
    w = torch.tensor(rng.standard_normal((5, 3, 6)) * 0.3)

    def step(psi, wt):
        B = torch.einsum("k,kij->ij", wt, A)
        return B @ psi + 0.5 * (B @ (B @ psi)), torch.sum(psi * psi)

    def loss(wk, remat):
        psi = torch.ones((4, 2), dtype=wk.dtype)
        pen = 0.0
        for t in range(wk.shape[1]):
            psi, p = (recompute(step, psi, wk[:, t]) if remat
                      else step(psi, wk[:, t]))
            pen = pen + p
        return torch.sum(psi * psi) + pen, pen

    grads, values = {}, {}
    for remat in (False, True):
        g, (val, _) = torch.func.vmap(torch.func.grad_and_value(
            lambda wk: loss(wk, remat), has_aux=True))(w)
        x = w[0].clone().requires_grad_(True)
        val_eager, _ = loss(x, remat)
        grads[remat] = (g, torch.autograd.grad(val_eager, x)[0])
        values[remat] = (val, val_eager.detach())
    for a, b in zip(grads[True] + values[True], grads[False] + values[False]):
        assert torch.equal(a, b)
