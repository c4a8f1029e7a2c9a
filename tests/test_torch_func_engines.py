"""The pscan and tree engines under ``torch.func`` (the batch layer's
vmapped ``"xla"`` backend calls each seed's loss under
``vmap(grad_and_value)``).

``batched_grape_adam(backend="xla", engine="pscan")`` against qoc_tpu's
same call, with and without a per-seed generator sweep; ``vmap(grad)``
through ``pscan_chain`` against a loop of per-seed ``autograd.grad``; and
the tree kernels' Function under ``vmap(grad)`` with stand-in launchers
(kernels 1-2 run on the card only), against the plain chain; the pscan
sweeps' own vmap rules, on the plain path and, with stand-in launchers, as
one launch a direction for every seed.  Inputs are
made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu.parallel.batch as jbatch
import qoc_tpu_torch.parallel.batch as tbatch
from qoc_tpu.models.system import ControlProblem
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.ops.propagation import (
    _PscanChain, _PscanReverse, _PscanSweep, pscan_chain, pscan_reverse_sweep,
    pscan_sweep)
from qoc_tpu_torch.ops.tree_chain import (
    _TreeBackward, _TreeChain, tree_chain_reference)

torch.set_num_threads(1)


def _leakage_args(levels=8, steps=12):
    """tests/test_torch_batch.py's leakage ladder (M = 2 * levels)."""
    a = q.annihilate(levels)
    return ((np.diag(np.arange(levels) * 1.0) * 2 * np.pi
             - 2 * np.pi * 0.05 * np.diag(np.arange(levels) ** 2 * 1.0),
             [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             [np.eye(levels)[1].astype(complex)], 2.0, steps,
             [np.eye(levels)[0].astype(complex)]),
            dict(state_transfer=True, maxA=[0.5, 0.5], seed=0))


def _anharmonicity_sweep(p, S):
    """Per-seed generator stacks [S, K+1, M, M]: the drift plus
    delta_s * n^2 for delta_s in 0..0.3."""
    n2 = np.diag(np.arange(p.state_num, dtype=float) ** 2)
    out = []
    for delta in np.linspace(0.0, 0.3, S):
        mats = np.asarray(p.mats, dtype=np.float32).copy()
        mats[0] += q.c_to_r_mat(-1j * p.dt * delta * n2).astype(np.float32)
        out.append(mats)
    return np.stack(out)


@pytest.mark.parametrize("sweep", [False, True], ids=["plain", "mats_batch"])
def test_pscan_batched_grape_adam_matches_qoc_tpu(sweep, monkeypatch):
    """qoc_tpu's result dict from the same initial pulses, 3 seeds, 5
    iterations, the 8-level ladder (M = 16, T = 12); the bars of
    tests/test_torch_batch.py's xla backend (losses 2e-5, pulses 5e-5)."""
    args, kw = _leakage_args()
    jp, tp = ControlProblem.build(*args, **kw), TorchProblem.build(*args,
                                                                   **kw)
    rng = np.random.default_rng(7)
    U = (rng.standard_normal((3, jp.ops_len, jp.steps))
         / np.sqrt(jp.steps)).astype(np.float32)
    monkeypatch.setattr(jbatch, "init_seeds",
                        lambda problem, n, key: jnp.asarray(U))
    monkeypatch.setattr(tbatch, "init_seeds",
                        lambda problem, n, generator, device: torch.tensor(
                            U).to(device))
    opts = dict(convergence={"rate": 0.05, "update_step": 10,
                             "max_iterations": 5, "conv_target": 1e-6},
                backend="xla", engine="pscan", seed=0)
    if sweep:
        opts["mats_batch"] = _anharmonicity_sweep(jp, 3)
    want = jbatch.batched_grape_adam(jp, n_seeds=3, **opts)
    got = tbatch.batched_grape_adam(tp, n_seeds=3, device="cpu", **opts)
    assert got["iterations"] == want["iterations"]
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["losses"], want["losses"], atol=2e-5)
    np.testing.assert_allclose(got["reg_losses"], want["reg_losses"],
                               atol=2e-5)
    np.testing.assert_allclose(got["u_base"], want["u_base"], atol=5e-5)
    np.testing.assert_allclose(got["uks"], want["uks"], atol=5e-5)


@pytest.mark.parametrize("reps", [1, 2])
def test_vmapped_pscan_gradient_matches_a_seed_loop(reps):
    """vmap(grad) through ``pscan_chain`` over 3 seeds' weights, mats
    shared and per seed, against per-seed ``torch.autograd.grad``, 1e-6."""
    rng = np.random.default_rng(3)
    S, K, M, T, V, order = 3, 3, 16, 6, 2, 5
    mats = torch.tensor((rng.standard_normal((S, K, M, M)) * 0.1)
                        .astype(np.float32))
    w = torch.tensor(rng.standard_normal((S, K, T)).astype(np.float32))
    psi0 = torch.tensor(rng.standard_normal((M, V)).astype(np.float32))
    R = torch.tensor(rng.standard_normal((T * reps + 1, M, V))
                     .astype(np.float32))

    def loss(w_, m_):
        return torch.sum(pscan_chain(m_, w_, psi0, order, reps) * R)

    for m_dim in (None, 0):
        m_in = mats[0] if m_dim is None else mats
        got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                              in_dims=(0, m_dim))(w, m_in)
        for s in range(S):
            ws = w[s].clone().requires_grad_(True)
            ms = (m_in if m_dim is None else m_in[s]).clone()
            ms.requires_grad_(True)
            want = torch.autograd.grad(loss(ws, ms), (ws, ms))
            np.testing.assert_allclose(got[0][s].numpy(), want[0].numpy(),
                                       atol=1e-6)
            np.testing.assert_allclose(got[1][s].numpy(), want[1].numpy(),
                                       atol=1e-6)


@pytest.mark.parametrize("dims", [(0, None), (None, 0), (0, 0)],
                         ids=["q_batched", "x_batched", "both"])
def test_sweep_vmap_rules_on_the_plain_path(dims):
    """The sweeps' own vmap rules on the CPU (the plain loops over the
    seeds dimension) against a loop of per-seed sweeps, 1e-6: Q per seed
    and psi0 or g shared, the other way round, and both per seed."""
    rng = np.random.default_rng(11)
    S, T, M, V, reps = 3, 6, 16, 2, 2

    def make(shape, batched):
        x = rng.standard_normal(((S,) if batched else ()) + shape)
        return torch.tensor(x.astype(np.float32))

    Q = torch.eye(M) + 0.1 * make((T, M, M), dims[0] == 0)
    psi0 = make((M, V), dims[1] == 0)
    g = make((T * reps + 1, M, V), dims[1] == 0)
    vecs = torch.func.vmap(pscan_sweep, in_dims=(*dims, None))(Q, psi0, reps)
    lams, bar = torch.func.vmap(pscan_reverse_sweep,
                                in_dims=(*dims, None))(Q, g, reps)
    for s in range(S):
        Qs = Q[s] if dims[0] == 0 else Q
        xs, gs = (psi0[s], g[s]) if dims[1] == 0 else (psi0, g)
        np.testing.assert_allclose(vecs[s].numpy(),
                                   pscan_sweep(Qs, xs, reps).numpy(),
                                   atol=1e-6)
        want_l, want_b = pscan_reverse_sweep(Qs, gs, reps)
        np.testing.assert_allclose(lams[s].numpy(), want_l.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(bar[s].numpy(), want_b.numpy(), atol=1e-6)


@pytest.mark.parametrize("reps", [1, 2])
def test_vmapped_pscan_chain_launches_each_sweep_once(reps, monkeypatch):
    """vmap(grad) through ``pscan_chain`` on the card's route, with
    stand-in launchers (the kernels run on the card only): the seeds reach
    one launch a direction, and the gradients are the per-seed loop's,
    1e-6."""
    from test_torch_pscan_sweep import stand_in_launchers

    calls = {"pscan_forward": [], "pscan_reverse": []}
    stand_in_launchers(monkeypatch, calls)
    rng = np.random.default_rng(4)
    S, K, M, T, V, order = 3, 3, 16, 6, 2, 5
    mats = torch.tensor((rng.standard_normal((K, M, M)) * 0.1)
                        .astype(np.float32))
    w = torch.tensor(rng.standard_normal((S, K, T)).astype(np.float32))
    psi0 = torch.tensor(rng.standard_normal((M, V)).astype(np.float32))
    R = torch.tensor(rng.standard_normal((T * reps + 1, M, V))
                     .astype(np.float32))

    def loss(w_):
        return torch.sum(pscan_chain(mats, w_, psi0, order, reps) * R)

    got = torch.func.vmap(torch.func.grad(loss))(w)
    assert calls == {"pscan_forward": [S], "pscan_reverse": [S]}
    monkeypatch.undo()
    for s in range(S):
        ws = w[s].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(loss(ws), ws)
        np.testing.assert_allclose(got[s].numpy(), want.numpy(), atol=1e-6)


def _stand_in_launchers(monkeypatch, calls):
    """Kernels 1-2 replaced by plain torch with the launchers' signatures:
    the forward returns a stand-in for the segment and block products, and
    the backward takes the gradient of the plain chain through the padded
    weights it is given."""

    def forward(mats, w, order, scaling):
        calls["tree_forward"] += 1
        E = tree_chain_reference(mats, w, order, scaling)
        return E, mats.new_zeros(1)

    def backward(mats, w, res, gbar, order, scaling):
        calls["tree_backward"] += 1
        with torch.enable_grad():
            wp = w.detach().requires_grad_(True)
            (wbar,) = torch.autograd.grad(
                tree_chain_reference(mats, wp, order, scaling), wp, gbar)
        return wbar

    monkeypatch.setattr(_cuda, "tree_forward", forward)
    monkeypatch.setattr(_cuda, "tree_backward", backward)


def test_tree_function_under_vmap_grad(monkeypatch):
    """vmap(grad) through the tree kernels' Function over 4 seeds (each
    kernel launched once per seed by the vmap rules) against the plain
    chain's per-seed gradient, 1e-6."""
    calls = {"tree_forward": 0, "tree_backward": 0}
    _stand_in_launchers(monkeypatch, calls)
    rng = np.random.default_rng(5)
    S, K, M, T, order, s = 4, 3, 4, 10, 3, 1
    mats = torch.tensor((rng.standard_normal((K, M, M)) * 0.2)
                        .astype(np.float32))
    w = torch.tensor(rng.standard_normal((S, K, T)).astype(np.float32))
    R = torch.tensor(rng.standard_normal((M, M)).astype(np.float32))

    def loss(w_):
        return torch.sum(_TreeChain.apply(mats, w_, order, s)[0] * R)

    got = torch.func.vmap(torch.func.grad(loss))(w)
    assert calls == {"tree_forward": S, "tree_backward": S}
    for b in range(S):
        wb = w[b].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(torch.sum(
            tree_chain_reference(mats, wb, order, s) * R), wb)
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), atol=1e-6)


def test_engine_functions_are_new_style():
    """The Functions take their context in ``setup_context`` and carry a
    vmap rule (generated for pscan, written out for the tree kernels and
    the pscan sweeps)."""
    for fn in (_PscanChain, _TreeChain, _TreeBackward, _PscanSweep,
               _PscanReverse):
        assert fn.setup_context is not torch.autograd.Function.setup_context
    assert _PscanChain.generate_vmap_rule
    for fn in (_TreeChain, _TreeBackward, _PscanSweep, _PscanReverse):
        assert fn.vmap is not torch.autograd.Function.vmap
