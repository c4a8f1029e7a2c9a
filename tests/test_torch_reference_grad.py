"""The reference-parity gradient, ``remat`` and the complex representation
in the port against qoc_tpu on the CPU: both reference Functions against
qoc_tpu's custom VJPs with random cotangents, reference-mode Adam
trajectories (tests/test_reference_trajectory.py's set-ups), the batch
layer's vmapped backend in reference mode, remat against no remat, and
``representation="complex"`` against qoc_tpu's and against the iso
forward.  Inputs are made with numpy from a seed and handed to both
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu.parallel.batch as jbatch
import qoc_tpu_torch.parallel.batch as tbatch
from qoc_tpu.models.forward import make_forward as q_make_forward
from qoc_tpu.models.system import ControlProblem as QProblem
from qoc_tpu.ops import propagation as qprop
from qoc_tpu.optim.adam import (init_adam_state as q_init_adam,
                                make_adam_optimizer,
                                make_segment_runner as q_segment_runner)
from qoc_tpu.optim.convergence import ConvergenceSettings as QConv
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.ops import propagation as tprop
from qoc_tpu_torch.optim.adam import init_adam_state, make_segment_runner
from qoc_tpu_torch.optim.convergence import ConvergenceSettings

torch.set_num_threads(1)


def _generators(K, M, T, seed):
    """Anti-Hermitian-like real generators and weights (drift row 1)."""
    rng = np.random.default_rng(seed)
    mats = rng.standard_normal((K, M, M)).astype(np.float32) * 0.2
    mats = (mats - np.transpose(mats, (0, 2, 1))) / 2
    w = rng.standard_normal((K, T)).astype(np.float32)
    w[0] = 1.0
    return mats, w, rng


# ---- the Functions against qoc_tpu's custom VJPs ---------------------------

@pytest.mark.parametrize("order,scaling", [(4, 0), (6, 2)])
def test_step_propagators_ref_grad_matches_qoc_tpu(order, scaling):
    """Forward to 1e-6 and the VJP (zero for mats and the drift row) to
    1e-5 relative, for a random cotangent."""
    mats, w, rng = _generators(3, 6, 9, 0)
    G = rng.standard_normal((9, 6, 6)).astype(np.float32)
    P_q, vjp = jax.vjp(lambda m, x: qprop.step_propagators_ref_grad(
        m, x, order, scaling), jnp.asarray(mats), jnp.asarray(w))
    mbar_q, wbar_q = vjp(jnp.asarray(G))
    m_t = torch.tensor(mats, requires_grad=True)
    w_t = torch.tensor(w, requires_grad=True)
    P_t = tprop.step_propagators_ref_grad(m_t, w_t, order, scaling)
    mbar, wbar = torch.autograd.grad(P_t, (m_t, w_t), torch.tensor(G))
    np.testing.assert_allclose(P_t.detach().numpy(), np.asarray(P_q),
                               atol=1e-6)
    assert not mbar.any() and not np.asarray(mbar_q).any()
    assert not wbar[0].any()
    scale = float(np.abs(np.asarray(wbar_q)).max())
    np.testing.assert_allclose(wbar.numpy(), np.asarray(wbar_q), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("order", [2, 5])
def test_matvec_step_ref_matches_qoc_tpu(order):
    """One state-transfer step: psi' to 1e-6, and (mats, w, psi) bars for
    a random cotangent to 1e-5 relative (psibar is exp(-A) Gbar)."""
    mats, w, rng = _generators(4, 8, 1, 1)
    psi = rng.standard_normal((8, 2)).astype(np.float32)
    G = rng.standard_normal((8, 2)).astype(np.float32)
    out_q, vjp = jax.vjp(lambda m, x, p: qprop._matvec_step_ref(
        m, x, p, order), jnp.asarray(mats), jnp.asarray(w[:, 0]),
        jnp.asarray(psi))
    bars_q = vjp(jnp.asarray(G))
    m_t = torch.tensor(mats, requires_grad=True)
    w_t = torch.tensor(w[:, 0], requires_grad=True)
    p_t = torch.tensor(psi, requires_grad=True)
    out = tprop.matvec_step_ref(m_t, w_t, p_t, order)
    bars = torch.autograd.grad(out, (m_t, w_t, p_t), torch.tensor(G))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_q),
                               atol=1e-6)
    assert not bars[0].any() and float(bars[1][0]) == 0.0
    for got, want in zip(bars[1:], bars_q[1:]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_reference_functions_under_vmap_grad():
    """The generated vmap rules: vmap(grad) over seeds equals a loop of
    per-seed autograd for both Functions."""
    mats, w, rng = _generators(3, 4, 6, 2)
    W = torch.tensor(rng.standard_normal((3, 3, 6)).astype(np.float32))
    m_t = torch.tensor(mats)
    psi0 = torch.tensor(rng.standard_normal((4, 1)).astype(np.float32))

    def loss(wb):
        P = tprop.step_propagators_ref_grad(m_t, wb, 3, 1)
        psi = tprop.matvec_step_ref(m_t, wb[:, 0], psi0, 3)
        return (torch.sum(tprop.chain_product_tree(P) @ psi0 * psi0)
                + torch.sum(psi * psi))

    got = torch.func.vmap(torch.func.grad(loss))(W)
    for s in range(3):
        ws = W[s].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(loss(ws), ws)
        torch.testing.assert_close(got[s], want, rtol=1e-5, atol=1e-6)


# ---- reference-mode trajectories -------------------------------------------

def _state_transfer_case():
    """tests/test_reference_trajectory.py:116's problem."""
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 6.0, 20,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[0.8, 0.8], seed=3))


def _unitary_case():
    """tests/test_reference_trajectory.py:224's problem."""
    return ((np.zeros((2, 2), dtype=complex),
             [q.SIGMA_X, q.SIGMA_Y, q.SIGMA_Z], ["x", "y", "z"],
             q.hadamard(1), 6.0, 12, [0, 1]),
            dict(maxA=[0.9] * 3, seed=5, Taylor_terms=[7, 1]))


@pytest.mark.parametrize("case,engine", [
    ("state_transfer", "scan"), ("unitary", "scan"),
    ("unitary", "associative")])
def test_reference_mode_adam_trajectory_matches_qoc_tpu(case, engine):
    """5 Adam iterations in reference mode: the pulse to 2e-5 (the bar of
    tests/test_reference_trajectory.py) and the loss to 1e-5 each
    iteration, the reference gradient at iteration 0 to 1e-4 relative."""
    args, kw = (_state_transfer_case if case == "state_transfer"
                else _unitary_case)()
    conv = {"rate": 0.01, "update_step": 1, "max_iterations": 8,
            "conv_target": 0.0, "min_grad": 0.0}
    qp, tp = QProblem.build(*args, **kw), ControlProblem.build(*args, **kw)
    _, q_loss = q_make_forward(qp, gradient_mode="reference", engine=engine,
                               lean=True)
    _, loss = make_forward(tp, gradient_mode="reference", engine=engine,
                           lean=True, device="cpu")
    opt = make_adam_optimizer(QConv.from_dict(conv))
    q_run, _ = q_segment_runner(q_loss, QConv.from_dict(conv), opt)
    run = make_segment_runner(loss, ConvergenceSettings.from_dict(conv))
    qs = q_init_adam(qp.u0_base, opt)
    s = init_adam_state(torch.as_tensor(tp.u0_base),
                        ConvergenceSettings.from_dict(conv))
    for i in range(5):
        qs = q_run(qs, jnp.asarray(i + 1, dtype=jnp.int32))
        s = run(s, i + 1)
        np.testing.assert_allclose(s.u_base.numpy(), np.asarray(qs.u_base),
                                   rtol=0, atol=2e-5, err_msg=str(i))
        assert abs(s.loss - float(qs.loss)) <= 1e-5
    u0 = torch.as_tensor(tp.u0_base).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(u0)[0], u0)
    gq = np.asarray(jax.grad(lambda u: q_loss(u)[0])(jnp.asarray(qp.u0_base)))
    assert (np.abs(g.numpy() - gq).max() / np.abs(gq).max()) < 1e-4


def test_reference_gradient_differs_from_exact():
    """The reference mode is not the exact gradient under another name."""
    args, kw = _state_transfer_case()
    tp = ControlProblem.build(*args, **kw)
    grads = []
    for mode in ("exact", "reference"):
        _, loss = make_forward(tp, gradient_mode=mode, lean=True,
                               device="cpu")
        u = torch.as_tensor(tp.u0_base).requires_grad_(True)
        grads.append(torch.autograd.grad(loss(u)[0], u)[0])
    assert float((grads[0] - grads[1]).abs().max()) > 1e-4


def test_grape_reference_gradient_meets_e2e_bar():
    """tests/test_grape_e2e.py:50: the pi pulse in reference mode reaches
    loss < 1e-4."""
    import qoc_tpu_torch as qt

    res = qt.Grape(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, 100,
        [np.array([1, 0], dtype=complex)], state_transfer=True, save=False,
        show_plots=False, device="cpu",
        convergence={"rate": 0.01, "update_step": 50,
                     "max_iterations": 1000, "conv_target": 1e-4},
        maxA=[0.7, 0.7], seed=0, gradient_mode="reference")
    assert res.loss < 1e-4
    assert res.engine == "scan"


def test_batched_reference_mode_matches_qoc_tpu(monkeypatch):
    """batched_grape_adam(gradient_mode="reference", backend="xla") from
    the same initial pulses, 3 seeds, 5 iterations: losses and pulses at
    tests/test_torch_batch.py's xla bars (2e-5, 5e-5)."""
    args, kw = _state_transfer_case()
    jp, tp = QProblem.build(*args, **kw), ControlProblem.build(*args, **kw)
    rng = np.random.default_rng(11)
    U = (rng.standard_normal((3, jp.ops_len, jp.steps))
         / np.sqrt(jp.steps)).astype(np.float32)
    monkeypatch.setattr(jbatch, "init_seeds",
                        lambda problem, n, key: jnp.asarray(U))
    monkeypatch.setattr(tbatch, "init_seeds",
                        lambda problem, n, generator, device: torch.tensor(
                            U).to(device))
    opts = dict(convergence={"rate": 0.05, "update_step": 10,
                             "max_iterations": 5, "conv_target": 1e-8},
                backend="xla", gradient_mode="reference", seed=0)
    want = jbatch.batched_grape_adam(jp, n_seeds=3, **opts)
    got = tbatch.batched_grape_adam(tp, n_seeds=3, device="cpu", **opts)
    assert got["iterations"] == want["iterations"]
    np.testing.assert_allclose(got["losses"], want["losses"], atol=2e-5)
    np.testing.assert_allclose(got["u_base"], np.asarray(want["u_base"]),
                               atol=5e-5)


# ---- remat ------------------------------------------------------------------

def _loss_and_grad(loss_fn, u0):
    u = torch.as_tensor(u0).requires_grad_(True)
    reg, _ = loss_fn(u)
    return float(reg.detach()), torch.autograd.grad(reg, u)[0]


@pytest.mark.parametrize("case", ["unitary", "state_final", "state_traj"])
def test_remat_gives_the_same_loss_and_gradient(case):
    """remat recomputes in the backward pass and changes nothing else:
    loss to 1e-6 and gradient to 1e-5 (tests/test_propagation.py's remat
    bars), for the unitary step propagators, the final-only state scan
    (sqrt(T) chunks, a short last chunk) and the trajectory scan."""
    if case == "unitary":
        args, kw = _unitary_case()
        rc, engine = None, "associative"
    else:
        args, kw = _state_transfer_case()
        rc = ({"speed_up": 0.01} if case == "state_traj" else None)
        engine = "scan"
    tp = ControlProblem.build(*args, **kw)
    out = []
    for remat in (False, True):
        _, loss = make_forward(tp, reg_coeffs=rc, engine=engine, lean=True,
                               remat=remat, device="cpu")
        out.append(_loss_and_grad(loss, tp.u0_base))
    assert abs(out[0][0] - out[1][0]) <= 1e-6
    torch.testing.assert_close(out[1][1], out[0][1], rtol=0, atol=1e-5)


def test_remat_through_grape_matches_qoc_tpu():
    """tests/test_grape_e2e.py:414 on the port: remat with the scan
    engine converges; its trajectory is qoc_tpu's."""
    import qoc_tpu_torch as qt

    common = dict(state_transfer=True, save=False, show_plots=False,
                  convergence={"rate": 0.01, "update_step": 50,
                               "max_iterations": 1000, "conv_target": 1e-4},
                  maxA=[0.7, 0.7], seed=0, remat=True, engine="scan")
    args = (np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
            ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 100,
            [np.array([1, 0], dtype=complex)])
    got = qt.Grape(*args, device="cpu", **common)
    want = q.Grape(*args, **common)
    assert got.loss < 1e-4
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.uks, np.asarray(want.uks), atol=1e-4)


# ---- the complex representation ----------------------------------------------

def _complex_problems():
    """tests/test_propagation.py:308-360's problems."""
    rng = np.random.default_rng(0)

    def herm(n):
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (A + A.conj().T) / 10

    N = 5
    H0 = np.diag(np.arange(N)).astype(complex) * 0.3
    Hops = [herm(N), herm(N)]
    U = np.eye(N, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    gate = ((H0, Hops, ["a", "b"], U, 5.0, 40, [0, 1]),
            dict(maxA=[1.0] * 2, seed=0), {"amplitude": 0.1, "dwdt": 0.01})
    transfer = ((H0, Hops, ["a", "b"], [np.eye(N, dtype=complex)[:, 1]],
                 5.0, 30, [np.eye(N, dtype=complex)[:, 0]]),
                dict(state_transfer=True, maxA=[1.0] * 2, seed=0),
                {"forbidden_coeff_list": [1.0], "states_forbidden_list": [3]})
    return {"gate": gate, "transfer": transfer}


@pytest.mark.parametrize("case", ["gate", "transfer"])
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "analysis"])
def test_complex_representation(case, lean):
    """Against qoc_tpu's complex forward and the port's iso forward:
    loss and reg_loss to 1e-6, unitary_scale to 1e-5, gradients to 1e-6,
    inter_vecs and final_state to 1e-5 (tests/test_propagation.py's
    tolerances); resolved_engine "complex"."""
    args, kw, rc = _complex_problems()[case]
    qp, tp = QProblem.build(*args, **kw), ControlProblem.build(*args, **kw)
    _, q_cpx = q_make_forward(qp, reg_coeffs=rc, representation="complex",
                              lean=lean)
    _, cpx = make_forward(tp, reg_coeffs=rc, representation="complex",
                          lean=lean, device="cpu")
    _, iso = make_forward(tp, reg_coeffs=rc, representation="iso",
                          lean=lean, engine="scan", device="cpu")
    assert cpx.resolved_engine == "complex"
    u = torch.as_tensor(tp.u0_base).requires_grad_(True)
    rl_c, oc = cpx(u)
    (g_c,) = torch.autograd.grad(rl_c, u)
    rl_i, oi = iso(u)
    (g_i,) = torch.autograd.grad(rl_i, u)
    rl_q, oq = q_cpx(jnp.asarray(qp.u0_base))
    g_q = np.asarray(jax.grad(lambda x: q_cpx(x)[0])(
        jnp.asarray(qp.u0_base)))
    def host(x):
        return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)

    for want_rl, want_o in ((rl_q, oq), (rl_i, oi)):
        assert abs(host(rl_c) - host(want_rl)) <= 1e-6
        assert abs(host(oc.loss) - host(want_o.loss)) <= 1e-6
        assert abs(host(oc.unitary_scale)
                   - host(want_o.unitary_scale)) <= 1e-5
        np.testing.assert_allclose(host(oc.final_state),
                                   host(want_o.final_state), atol=1e-5)
        if want_o.inter_vecs is not None:
            np.testing.assert_allclose(host(oc.inter_vecs),
                                       host(want_o.inter_vecs), atol=1e-5)
    np.testing.assert_allclose(g_c.numpy(), g_q, atol=1e-6)
    np.testing.assert_allclose(g_c.numpy(), g_i.numpy(), atol=1e-6)


def test_complex_rejects_reference_gradients():
    args, kw, _ = _complex_problems()["gate"]
    with pytest.raises(ValueError, match="exact gradients"):
        make_forward(ControlProblem.build(*args, **kw),
                     representation="complex", gradient_mode="reference",
                     device="cpu")
