"""The port's pscan and associative engines and its engine ladders against
qoc_tpu's, on the CPU.

Each engine of ``qoc_tpu_torch.ops.propagation`` is held against the same
engine of ``qoc_tpu.ops.propagation`` (not port against port): values,
gradients in weights, generators and initial states, the unitary pscan
forward of ``models.forward``, and the routing ladders.  Then the engines
end to end: config 4 (examples/jobs/transmon_cavity.json, M = 120, T = 1000)
at iteration 0 through both packages' pscan engine, and ``Grape`` with
``engine="pscan"`` and ``"associative"`` on a small transmon-cavity state
transfer.  Inputs are made with numpy from a seed and handed to both."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu_torch as qt
from qoc_tpu.cli import load_config
from qoc_tpu.models.forward import make_forward as j_make_forward
from qoc_tpu.models.system import ControlProblem as JProblem
from qoc_tpu.ops import propagation as jprop
from qoc_tpu.ops.isomorphism import c_to_r_mat
from qoc_tpu.routing import resolve_single_engine as j_resolve_single
from qoc_tpu_torch import routing as troute
from qoc_tpu_torch.models.forward import make_forward as t_make_forward
from qoc_tpu_torch.models.system import ControlProblem as TProblem
from qoc_tpu_torch.ops import propagation as tprop
from qoc_tpu_torch.utils.jobs import load_job

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG4 = os.path.join(HERE, "..", "examples", "jobs", "transmon_cavity.json")


def _chain_inputs(T, V=1, n=3, K=2, dt=0.05, seed=0):
    """tests/test_propagation.py's setup_problem: mats [K+1, 2n, 2n] of
    -i dt H for random Hermitian H, weights [K+1, T] (drift row 1), psi0
    [2n, V] and a target of the same shape."""
    rng = np.random.default_rng(seed)
    hs = []
    for _ in range(K + 1):
        h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        hs.append(c_to_r_mat(-1j * dt * (h + h.conj().T) / 2))
    mats = np.stack(hs).astype(np.float32)
    u = 0.5 * rng.standard_normal((K, T)).astype(np.float32)
    w = np.concatenate([np.ones((1, T), np.float32), u])
    psi0 = np.eye(2 * n, V, dtype=np.float32)
    tgt = rng.standard_normal((2 * n, V)).astype(np.float32)
    return mats, w, psi0, tgt


@pytest.mark.parametrize("final_only", [False, True])
@pytest.mark.parametrize("engine", ["associative", "pscan"])
def test_state_chain_matches_qoc_tpu(engine, final_only):
    mats, w, psi0, _ = _chain_inputs(T=12, V=2)
    want = np.asarray(jprop.state_transfer_chain(
        jnp.asarray(mats), jnp.asarray(w), jnp.asarray(psi0), order=10,
        engine=engine, final_only=final_only))
    got = tprop.state_transfer_chain(
        torch.tensor(mats), torch.tensor(w), torch.tensor(psi0), 10,
        engine=engine, final_only=final_only).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def _trajectory_loss(vecs, tgt, lib):
    """Reads every step, as speed_up and forbidden do."""
    return lib.sum(vecs[-1] * tgt) + 1e-2 * lib.sum(vecs * vecs)


@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("final_only", [False, True])
@pytest.mark.parametrize("engine", ["associative", "pscan"])
def test_chain_gradients_match_qoc_tpu(engine, final_only, V):
    """Gradients in weights, mats and psi0 (the batch layer's mats sweep
    differentiates through mats), 1e-4."""
    mats, w, psi0, tgt = _chain_inputs(T=15, V=V, seed=V)

    def j_loss(m, w_, p):
        vecs = jprop.state_transfer_chain(m, w_, p, order=10, engine=engine,
                                          final_only=final_only)
        return _trajectory_loss(vecs, jnp.asarray(tgt), jnp)

    want = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(mats), jnp.asarray(w), jnp.asarray(psi0))
    m_t, w_t, p_t = (torch.tensor(x, requires_grad=True)
                     for x in (mats, w, psi0))
    vecs = tprop.state_transfer_chain(m_t, w_t, p_t, 10, engine=engine,
                                      final_only=final_only)
    val = _trajectory_loss(vecs, torch.tensor(tgt), torch)
    got = torch.autograd.grad(val, (m_t, w_t, p_t))
    np.testing.assert_allclose(float(val.detach()), float(want[0]), atol=1e-5)
    for g_t, g_j in zip(got, want[1]):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)


@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 13])
def test_chain_associative_matches_qoc_tpu(T):
    """The prefix product stands in for lax.associative_scan: final
    unitary and inter_vecs of qoc_tpu's chain_associative, with a
    non-identity U0."""
    mats, w, psi0, _ = _chain_inputs(T=T, V=2, seed=T)
    U0 = np.linalg.qr(np.random.default_rng(T).standard_normal((6, 6)))[0]
    U0 = U0.astype(np.float32)
    P = np.asarray(jprop.step_propagators(jnp.asarray(mats), jnp.asarray(w),
                                          8, 1))
    U_j, v_j = jprop.chain_associative(jnp.asarray(P), jnp.asarray(U0),
                                       jnp.asarray(psi0))
    U_t, v_t = tprop.chain_associative(torch.tensor(P), torch.tensor(U0),
                                       torch.tensor(psi0))
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


def _ladder_gate(n_concerned, **extra):
    a = q.annihilate(3)
    args = (np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
            [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
            q.transmon_gate(q.SIGMA_X, 3), 3.0, 14, list(range(n_concerned)))
    kwargs = dict(maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2], **extra)
    return JProblem.build(*args, **kwargs), TProblem.build(*args, **kwargs)


def _non_identity_u0():
    a = q.annihilate(3)
    U0 = (np.cos(0.3) * np.eye(3)
          - 1j * np.sin(0.3) * (a + a.conj().T) / np.sqrt(2))
    return np.linalg.qr(U0)[0]


@pytest.mark.parametrize("engine", ["pscan", "associative"])
def test_unitary_forward_matches_qoc_tpu(engine):
    """tests/test_propagation.py:222-261 against qoc_tpu's same engine: a
    real squaring branch (scaling 2), a non-identity U0 and a trajectory
    cost; loss, unitary_scale, final_state, inter_vecs and the u_base
    gradient."""
    jp, tp = _ladder_gate(2, U0=_non_identity_u0())
    assert tp.taylor_scaling == 2
    rc = {"forbidden_coeff_list": [2.0], "states_forbidden_list": [2]}
    f_j, l_j = j_make_forward(jp, reg_coeffs=rc, engine=engine)
    f_t, l_t = t_make_forward(tp, reg_coeffs=rc, engine=engine)
    u = np.asarray(jp.u0_base, np.float32)
    o_j = f_j(jnp.asarray(u))
    with torch.no_grad():
        o_t = f_t(torch.tensor(u))
    np.testing.assert_allclose(float(o_t.loss), float(o_j.loss), atol=1e-5)
    np.testing.assert_allclose(float(o_t.unitary_scale.detach()),
                               float(o_j.unitary_scale), atol=1e-5)
    np.testing.assert_allclose(o_t.final_state.numpy(),
                               np.asarray(o_j.final_state), atol=2e-5)
    np.testing.assert_allclose(o_t.inter_vecs.numpy(),
                               np.asarray(o_j.inter_vecs), atol=2e-5)
    g_j = np.asarray(jax.grad(lambda x: l_j(x)[0])(jnp.asarray(u)))
    ut = torch.tensor(u, requires_grad=True)
    (g_t,) = torch.autograd.grad(l_t(ut)[0], ut)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=2e-5)


def test_unitary_pscan_lean_matches_qoc_tpu():
    """The lean unitary pscan (no trajectory cost): loss and gradient as
    qoc_tpu's; the port leaves the unread product tree out."""
    jp, tp = _ladder_gate(1)
    _, l_j = j_make_forward(jp, engine="pscan", lean=True)
    _, l_t = t_make_forward(tp, engine="pscan", lean=True)
    u = np.asarray(jp.u0_base, np.float32)
    (v_j, o_j), g_j = jax.value_and_grad(l_j, has_aux=True)(jnp.asarray(u))
    ut = torch.tensor(u, requires_grad=True)
    v_t, o_t = l_t(ut)
    (g_t,) = torch.autograd.grad(v_t, ut)
    assert o_t.final_state is None and o_t.inter_vecs is None
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), atol=1e-5)
    np.testing.assert_allclose(float(o_t.unitary_scale.detach()),
                               float(o_j.unitary_scale), atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=2e-5)


def test_ladders_match_qoc_tpu():
    for M in (2, 4, 8, 12, 14, 16, 32, 64, 120, 128, 400, 512, 1024):
        for T in (1, 8, 100, 1000, 5000, 50000, 400000):
            assert tprop.pick_engine(M, T) == jprop.pick_engine(M, T)
            for mode in ("exact", "reference"):
                for on_accel in (False, True):
                    for final_only in (False, True):
                        args = (M, T, mode, final_only, on_accel)
                        assert (tprop.resolve_state_engine(*args)
                                == jprop.resolve_state_engine(*args)), args
                    for scaling in (0, 1, 3, 6):
                        for inter in (False, True):
                            args = (M, T, scaling, mode, inter, on_accel)
                            assert (tprop.resolve_unitary_engine(*args)
                                    == jprop.resolve_unitary_engine(*args)
                                    ), args


def _validation_problems(lib):
    """tests/test_validation.py:180-191's two problems."""
    a = lib.annihilate(3)
    psi0 = np.zeros(3, complex)
    psi0[0] = 1
    tgt = np.zeros(3, complex)
    tgt[1] = 1
    st = lib.ControlProblem.build(
        np.diag([0.0, 1.0, 1.9]), [a + a.conj().T], ["x"], [tgt], 2.0, 8,
        [psi0], state_transfer=True, maxA=[1.0], seed=0)
    un = lib.ControlProblem.build(
        np.diag([0.0, 1.0, 1.9]), [a + a.conj().T], ["x"],
        lib.transmon_gate(lib.SIGMA_X, 3), 2.0, 8, [0], maxA=[1.0], seed=0,
        Taylor_terms=[8, 1])
    return st, un


def test_resolve_single_engine_matches_qoc_tpu():
    """On the CPU (qoc_tpu's backend here) both packages resolve alike,
    and the port's make_forward reports what its routing says."""
    for jp, tp in zip(_validation_problems(q), _validation_problems(qt)):
        for rc in (None, {"speed_up": 0.1}):
            for eng in ("auto", "scan", "pscan", "associative"):
                for lean in (True, False):
                    want = j_resolve_single(jp, rc, "exact", eng, lean=lean)
                    got = troute.resolve_single_engine(
                        tp, rc, "exact", eng, lean=lean, device="cpu")
                    assert got == want, (jp.state_transfer, rc, eng, lean)
                    _, loss_fn = t_make_forward(tp, reg_coeffs=rc,
                                                engine=eng, lean=lean)
                    assert loss_fn.resolved_engine == got


def test_config4_routes_to_pscan_on_the_card():
    """Config 4's shape on an accelerator: pscan in both packages'
    ladders, and kernel 7 admits its batched Taylor step."""
    from qoc_tpu.ops.pallas_expm import fused_expm_supported as j_supported
    from qoc_tpu_torch.ops.fused_expm import fused_expm_supported

    for lib in (jprop, tprop):
        assert lib.resolve_state_engine(120, 1000, "exact", False,
                                        True) == "pscan"
    assert fused_expm_supported(120, 14, 0) and j_supported(120, 14, 0)


def _config4_problems():
    """Config 4 through each package's own job loader (the npz via numpy)."""
    names = ("H0", "Hops", "Hnames", "U", "total_time", "steps",
             "states_concerned_list")
    build = ("dressed_info", "maxA", "state_transfer", "seed")
    j_cfg, t_cfg = load_config(CONFIG4), load_job(CONFIG4)
    jp = JProblem.build(*(j_cfg[k] for k in names),
                        **{k: j_cfg[k] for k in build})
    tp = TProblem.build(*(t_cfg[k] for k in names),
                        **{k: t_cfg[k] for k in build})
    assert t_cfg["reg_coeffs"] == j_cfg["reg_coeffs"]
    return jp, tp, t_cfg["reg_coeffs"]


def test_config4_iteration0_matches_qoc_tpu():
    """Config 4 at full width: its iteration-0 reg_loss through
    both packages' lean pscan forward (rel 1e-5) and its gradient within
    PARITY.md's pass bar 1, max|dg| <= 5e-4 max|g|."""
    jp, tp, rc = _config4_problems()
    assert 2 * tp.state_num == 120 and tp.steps == 1000
    _, l_j = j_make_forward(jp, reg_coeffs=rc, engine="pscan", lean=True)
    _, l_t = t_make_forward(tp, reg_coeffs=rc, engine="pscan", lean=True)
    u = np.asarray(jp.u0_base, np.float32)
    np.testing.assert_array_equal(u, np.asarray(tp.u0_base, np.float32))
    (v_j, _), g_j = jax.value_and_grad(l_j, has_aux=True)(jnp.asarray(u))
    ut = torch.tensor(u, requires_grad=True)
    v_t, _ = l_t(ut)
    (g_t,) = torch.autograd.grad(v_t, ut)
    g_j = np.asarray(g_j)
    assert abs(float(v_t.detach()) - float(v_j)) <= 1e-5 * abs(float(v_j))
    assert np.max(np.abs(g_t.numpy() - g_j)) <= 5e-4 * np.max(np.abs(g_j))


def _small_transmon_cavity():
    """examples/jobs/make_transmon_cavity.py's system cut to a 2-level
    transmon x 4-level cavity (M = 16), bare basis, T = 40: one cavity
    photon from the vacuum, with the job's three costs."""
    qlev, clev = 2, 4
    aq, ac = q.annihilate(qlev), q.annihilate(clev)
    Iq, Ic = np.eye(qlev), np.eye(clev)
    coup = np.kron(aq, Ic) @ np.kron(Iq, ac).conj().T
    H0 = (2 * np.pi * 0.6 * np.kron(Iq, ac.conj().T @ ac)
          + 2 * np.pi * 0.1 * (coup + coup.conj().T))
    Hops = [np.kron(aq + aq.conj().T, Ic),
            np.kron(1j * (aq - aq.conj().T), Ic),
            np.kron(Iq, ac + ac.conj().T),
            np.kron(Iq, 1j * (ac - ac.conj().T))]
    psi0 = np.zeros(qlev * clev, complex)
    psi0[0] = 1
    tgt = np.zeros(qlev * clev, complex)
    tgt[1] = 1
    args = (H0, Hops, ["qx", "qy", "cx", "cy"], [tgt], 10.0, 40, [psi0])
    kwargs = dict(state_transfer=True, maxA=[2 * np.pi * 0.3] * 4, seed=0,
                  reg_coeffs={"dwdt": 1e-4, "bandpass": 0.1,
                              "band": [0.1, 10.0], "speed_up": 1e-4},
                  convergence={"rate": 0.02, "update_step": 2,
                               "max_iterations": 5, "conv_target": 1e-8},
                  save=False, show_plots=False)
    return args, kwargs


@pytest.mark.parametrize("engine", ["pscan", "associative"])
def test_grape_matches_qoc_tpu(engine):
    args, kwargs = _small_transmon_cavity()
    want = q.Grape(*args, engine=engine, **kwargs)
    got = qt.Grape(*args, engine=engine, device="cpu", **kwargs)
    assert got.engine == engine
    assert got.iterations == want.iterations == 5
    np.testing.assert_allclose(got.loss, want.loss, atol=2e-5)
    np.testing.assert_allclose(got.reg_loss, want.reg_loss, atol=2e-5)
    np.testing.assert_allclose(got.uks, np.asarray(want.uks), atol=1e-4)
    np.testing.assert_allclose(got.inter_vecs, np.asarray(want.inter_vecs),
                               atol=1e-4)
