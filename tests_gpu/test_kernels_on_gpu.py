"""The CUDA kernels on the card against float64 oracles and the port's
per-iteration engines (the counterpart of
tests_tpu/test_kernels_on_tpu.py, test for test, at its tolerances).

The TPU lane checked the Mosaic lowerings; here each test checks the
hand-written kernel its path launches (kernels 1-2 the tree chain, 4-5
the state chain, 7 the batched Taylor expm), and the dim-64 drift test is
the card's precision test: no TF32 anywhere on the path.
"""

import numpy as np
import pytest
import scipy.linalg as la
import torch

from conftest import (gap, launches, on, random_hermitian, state_problem,
                      unitary_problem)

from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.ops.propagation import (
    chain_product_tree,
    state_transfer_chain,
    step_propagators,
)
from qoc_tpu_torch.ops.state_chain import fused_state_chain
from qoc_tpu_torch.ops.tree_chain import fused_tree_chain
from qoc_tpu_torch.parallel.batch import init_seeds
from qoc_tpu_torch.parallel.cols_batch import (make_xla_batched_loss,
                                               xla_cols_supported)
from qoc_tpu_torch.routing import resolve_single_engine
from qoc_tpu_torch.utils.verification import scipy_oracle_states

pytestmark = pytest.mark.gpu


def _chain_inputs(problem, device, u_base=None):
    """(mats [K,M,M], weights [K,T], psi0 [M,V]) from a ControlProblem."""
    p = problem
    u = np.asarray(p.u0_base if u_base is None else u_base, dtype=np.float32)
    amps = np.asarray(p.ops_max_amp, dtype=np.float32)[:, None] * np.sin(u)
    w = np.concatenate([np.ones((1, p.steps), np.float32), amps], axis=0)
    return on(device, p.mats), on(device, w), on(device, p.initial_vectors)


def _columns(w, psi0):
    """The chain kernel's layout: w [T, K, C], every column the same."""
    return (w.T[:, :, None] * torch.ones((1, 1, psi0.shape[1]),
                                         device=w.device)).contiguous()


# ---------------------------------------------------------------------------
# chain kernel (state-transfer): float64 scipy oracle + scan gradients
# ---------------------------------------------------------------------------


def test_chain_kernel_final_state_vs_scipy_float64(device, record_property):
    p = state_problem(steps=64)
    mats, w, psi0 = _chain_inputs(p, device)
    with launches(device, "state_chain_forward"):
        out = fused_state_chain(mats, _columns(w, psi0), psi0,
                                p.taylor_terms).cpu().numpy()

    uks = np.asarray(p.ops_max_amp)[:, None] * np.sin(np.asarray(p.u0_base))
    states = scipy_oracle_states(
        np.asarray(p.H0_c), np.asarray(p.ops_c), uks,
        p.total_time, p.steps, p.initial_vectors_c[0])
    oracle = states[:, -1]  # [N] complex, float64 Pade propagation
    got = out[: p.state_num, 0] + 1j * out[p.state_num:, 0]
    record_property("state_gap", gap(got, oracle))
    np.testing.assert_allclose(got, oracle, atol=5e-6)


def test_chain_kernel_gradients_vs_xla_scan(device, record_property):
    p = state_problem(steps=64)
    mats, w, psi0 = _chain_inputs(p, device)
    tgt = on(device, p.target_vectors)

    def loss_kernel(wkt):
        fin = fused_state_chain(mats, _columns(wkt, psi0), psi0,
                                p.taylor_terms)
        return torch.sum(fin * tgt)

    def loss_scan(wkt):
        vecs = state_transfer_chain(mats, wkt, psi0, p.taylor_terms,
                                    engine="scan")
        return torch.sum(vecs[-1] * tgt)

    def grad(loss):
        x = w.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        return g.cpu().numpy()

    with launches(device, "state_chain_forward", "state_chain_backward"):
        gk = grad(loss_kernel)
    gs = grad(loss_scan)
    record_property("grad_gap", gap(gk[1:], gs[1:]))
    np.testing.assert_allclose(gk[1:], gs[1:], atol=2e-5)


# ---------------------------------------------------------------------------
# tree kernel (unitary): forward vs the product tree, gradient vs autograd
# ---------------------------------------------------------------------------


def test_tree_kernel_forward_and_grad_vs_xla(device, record_property):
    p = unitary_problem(steps=24)
    assert p.taylor_scaling == 2  # exercises the in-kernel squaring branch
    mats, w, _ = _chain_inputs(p, device)
    order, scaling = p.taylor_terms, p.taylor_scaling

    with launches(device, "tree_forward"):
        E_kernel = fused_tree_chain(mats, w, order, scaling).cpu().numpy()
    P = step_propagators(mats, w, order, scaling)
    E_plain = chain_product_tree(P).cpu().numpy()
    record_property("forward_gap", gap(E_kernel, E_plain))
    np.testing.assert_allclose(E_kernel, E_plain, atol=2e-6)

    seedmat = on(device, np.random.default_rng(7).normal(
        size=E_plain.shape))

    def lk(ww):
        return torch.sum(fused_tree_chain(mats, ww, order, scaling) * seedmat)

    def lx(ww):
        return torch.sum(
            chain_product_tree(step_propagators(mats, ww, order, scaling))
            * seedmat)

    def grad(loss):
        x = w.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        return g.cpu().numpy()

    with launches(device, "tree_forward", "tree_backward"):
        gk = grad(lk)
    gx = grad(lx)
    record_property("grad_gap", gap(gk[1:], gx[1:]))
    np.testing.assert_allclose(gk[1:], gx[1:], atol=3e-5)


# ---------------------------------------------------------------------------
# Matmul precision: unitarity drift at dim 64 (M = 128)
# ---------------------------------------------------------------------------


def test_unitarity_drift_dim64_on_gpu(device, rng, record_property):
    """The card's precision test (tests_tpu's MXU test): TF32 products
    would round the inputs to 10 mantissa bits and the chain would drift
    ~1e-4.  During the run TF32 is off and float32 matmuls run at
    "highest"; the unitarity bar holds and the final unitary agrees with
    a float64 host oracle at dim 64."""
    n = 64
    steps = 50
    H0 = random_hermitian(n, rng, scale=0.5)
    Hops = [random_hermitian(n, rng, scale=0.3) for _ in range(2)]
    U = np.eye(n, dtype=complex)
    # Taylor terms pinned: the reference's dim>=10 auto-search metric bounds
    # only the largest matrix ELEMENT and under-budgets dense random
    # Hermitians; this test isolates the matmul arithmetic, not that quirk.
    p = ControlProblem.build(
        H0, Hops, ["a", "b"], U, 5.0, steps, [0, 1, 2, 3],
        maxA=[1.0, 1.0], seed=3, Taylor_terms=[12, 6],
    )
    # the card's rung of the unitary ladder (on the CPU lane too: the
    # ladder's CPU rung, associative, drifts 3.1e-4 in float32 whatever the
    # matmul precision, in qoc_tpu on the CPU as here)
    engine = resolve_single_engine(p, None, "exact", "auto", lean=False,
                                   device="cuda")
    assert engine == "pscan"
    forward, _ = make_forward(p, engine=engine, device=device)

    def precision():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())

    with launches(device, "expm_forward"):
        assert precision() == (False, "highest")
        with torch.no_grad():
            out = forward(on(device, p.u0_base))
        assert precision() == (False, "highest")
    uscale = float(out.unitary_scale)
    record_property("unitarity_drift", abs(uscale - 1.0))
    assert abs(uscale - 1.0) < 1e-4, f"unitarity drifted: {uscale}"

    # final unitary vs float64 oracle (scipy Pade expm per step)
    uks = np.asarray(p.ops_max_amp)[:, None] * np.sin(np.asarray(p.u0_base))
    dt = p.total_time / steps
    Uo = np.eye(n, dtype=complex)
    for t in range(steps):
        H = H0 + uks[0, t] * Hops[0] + uks[1, t] * Hops[1]
        Uo = la.expm(-1j * dt * H) @ Uo
    F = out.final_state.cpu().numpy()
    got = F[:n, :n] + 1j * F[n:, :n]
    record_property("unitary_gap", gap(got, Uo))
    np.testing.assert_allclose(got, Uo, atol=2e-4)


# ---------------------------------------------------------------------------
# engine cross-checks on the card: scan vs associative, pscan vs scan
# ---------------------------------------------------------------------------


def test_engines_agree_on_device(device, record_property):
    p = state_problem(steps=64)
    mats, w, psi0 = _chain_inputs(p, device)
    scan = state_transfer_chain(mats, w, psi0, p.taylor_terms, engine="scan")
    asc = state_transfer_chain(mats, w, psi0, p.taylor_terms,
                               engine="associative")
    record_property("state_gap", gap(scan[-1].cpu(), asc[-1].cpu()))
    np.testing.assert_allclose(
        scan[-1].cpu().numpy(), asc[-1].cpu().numpy(), atol=2e-6)


def test_pscan_adjoint_grad_on_device(device, record_property):
    """The pscan matvec-adjoint VJP on the card (kernel 7's batched Q, the
    reverse sweep) vs scan autograd, value and gradient, at M = 32 with a
    trajectory-reading loss."""
    levels = 16
    a = np.diag(np.sqrt(np.arange(1, levels)), 1)
    H0 = np.diag(np.arange(levels, dtype=float)) * 0.3
    psi0 = np.zeros(levels, complex)
    psi0[0] = 1
    tgt = np.zeros(levels, complex)
    tgt[1] = 1
    p = ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        4.0, 50, [psi0], state_transfer=True, maxA=[1.0, 1.0], seed=0)
    mats, w, psi0r = _chain_inputs(p, device)

    def value_and_grad(engine):
        x = w.clone().requires_grad_(True)
        vecs = state_transfer_chain(mats, x, psi0r, p.taylor_terms,
                                    engine=engine)
        loss = torch.sum(torch.square(vecs[-1])) + 1e-2 * torch.sum(
            torch.square(vecs))
        (g,) = torch.autograd.grad(loss, x)
        return loss.item(), g.cpu().numpy()

    vs, gs = value_and_grad("scan")
    with launches(device, "expm_forward"):
        vp, gp = value_and_grad("pscan")
    record_property("value_gap", abs(vp - vs))
    record_property("grad_gap", gap(gp, gs))
    np.testing.assert_allclose(vp, vs, atol=1e-4)
    np.testing.assert_allclose(gp, gs, atol=1e-3)


def test_xla_cols_speed_up_on_device(device, record_property):
    """In-carry speed_up on the column-batched path (``cols_batch``)
    matches the per-seed generic forward on the card."""
    levels = 6
    a = np.diag(np.sqrt(np.arange(1, levels)), 1)
    psi0 = np.zeros(levels, complex)
    psi0[0] = 1
    tgt = np.zeros(levels, complex)
    tgt[1] = 1
    p = ControlProblem.build(
        np.diag(np.arange(levels, dtype=float)) * 0.5,
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        3.0, 16, [psi0], state_transfer=True, maxA=[1.0, 1.0], seed=0)
    rc = {"speed_up": 0.05}
    assert xla_cols_supported(p, rc)
    u = init_seeds(p, 3, torch.Generator().manual_seed(5), device)
    lx = make_xla_batched_loss(p, rc, device=device)
    with torch.no_grad():
        rx, _ = lx(u)
    _, loss_fn = make_forward(p, reg_coeffs=rc, lean=True, engine="scan",
                              device=device)
    with torch.no_grad():
        want = [float(loss_fn(u[s])[0]) for s in range(3)]
    record_property("loss_gap", gap(rx.cpu(), want))
    for s in range(3):
        np.testing.assert_allclose(float(rx[s]), want[s], atol=1e-4)
