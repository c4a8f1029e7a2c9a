"""The port's seed-batched layer against qoc_tpu's: the column-batched and
state-chain losses (values and gradients), ``make_batched_runner``
on each backend against the same qoc_tpu backend from the same pulses
(qoc_tpu's Pallas kernels interpreted on the CPU), a per-seed generator
sweep, ``batched_grape_adam`` with both packages' ``init_seeds`` returning
the same array, the backend gates and fallback reasons, the per-iteration
state carried across from qoc_tpu, ``init_seeds``, and the routing
lines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu.parallel.batch as jbatch
import qoc_tpu_torch.parallel.batch as tbatch
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.optim.convergence import ConvergenceSettings
from qoc_tpu.parallel.pallas_batch import (
    make_pallas_batched_loss as j_pallas_loss)
from qoc_tpu.parallel.pallas_batch import (
    pallas_batch_supported as j_pallas_supported)
from qoc_tpu.parallel.xla_batch import make_xla_batched_loss as j_cols_loss
from qoc_tpu.parallel.xla_batch import xla_cols_supported as j_cols_supported
from qoc_tpu.routing import fused_fallback_reasons as j_reasons
from qoc_tpu_torch.interop import batch_state_from_numpy, batch_state_to_numpy
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem
from qoc_tpu_torch.optim.convergence import ConvergenceSettings as TConv
from qoc_tpu_torch.parallel.batch import (
    batched_grape_adam, describe_backend, init_seeds, make_batched_runner)
from qoc_tpu_torch.parallel.chain_batch import (
    make_pallas_batched_loss, pallas_batch_supported)
from qoc_tpu_torch.parallel.cols_batch import (
    make_xla_batched_loss, xla_cols_supported)
from qoc_tpu_torch.routing import fused_fallback_reasons

torch.set_num_threads(1)

N_ITERS = 20
CONV = {"rate": 0.05, "update_step": 10, "max_iterations": 100,
        "conv_target": 1e-12}


def _pi_args(steps=16, **over):
    kw = dict(state_transfer=True, maxA=[0.7, 0.7], seed=0)
    kw.update(over)
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 2.0, steps,
             [np.array([1, 0], dtype=complex)]), kw)


def _leakage_args(levels=3, steps=12):
    a = q.annihilate(levels)
    return ((np.diag(np.arange(levels) * 1.0) * 2 * np.pi
             - 2 * np.pi * 0.05 * np.diag(np.arange(levels) ** 2 * 1.0),
             [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             [np.eye(levels)[1].astype(complex)], 2.0, steps,
             [np.eye(levels)[0].astype(complex)]),
            dict(state_transfer=True, maxA=[0.5, 0.5], seed=0))


def _gate_args():
    a = q.annihilate(3)
    return ((np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
             [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             q.transmon_gate(q.SIGMA_X, 3), 3.0, 12, [0, 1]),
            dict(maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2]))


def _problems(make):
    args, kwargs = make()
    return (ControlProblem.build(*args, **kwargs),
            TorchProblem.build(*args, **kwargs))


def _u0(p, S, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, p.ops_len, p.steps))
            / np.sqrt(p.steps)).astype(np.float32)


def _detuning_sweep(p, S):
    """Per-seed generator stacks [S, K+1, M, M]: drift detuned by delta_s."""
    out = []
    for delta in np.linspace(0.0, 0.4, S):
        mats = np.asarray(p.mats, dtype=np.float32).copy()
        mats[0] = q.c_to_r_mat(-1j * p.dt * np.diag([0.0, delta]))
        out.append(mats)
    return np.stack(out)


def _extra_channel(p, S):
    extra = np.stack([q.c_to_r_mat(-1j * p.dt * np.diag([0.0, 1.0]))])
    return (extra.astype(np.float32),
            np.linspace(-0.3, 0.3, S)[:, None].astype(np.float32))


def _dressed_args():
    a = q.annihilate(4)
    H0 = (2 * np.pi * 0.1 * np.diag(np.arange(4.0))
          + 2 * np.pi * 0.02 * (a + a.conj().T))
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    di = {"eigenvectors": v_c, "eigenvalues": np.real(w_c),
          "dressed_id": dressed_id, "is_dressed": True}
    return ((H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             [v_c[:, q.get_state_index(1, dressed_id)]], 3.0, 10,
             [v_c[:, q.get_state_index(0, dressed_id)]]),
            dict(state_transfer=True, dressed_info=di, maxA=[1.0, 1.0],
                 seed=0))


def _v12_args():
    N = 16
    rng = np.random.default_rng(0)
    A_ = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H0 = (A_ + A_.conj().T) / 8
    Hop = np.diag(np.arange(N, dtype=float)) / 4
    U = np.eye(N, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    return ((H0, [Hop, H0 @ Hop - Hop @ H0 + np.eye(N)], ["a", "b"], U, 4.0,
             10, list(range(12))),
            dict(maxA=[1.0, 1.0], seed=0, Taylor_terms=[8, 1]))


def _gate_u0_args():
    a = q.annihilate(3)
    U0, _ = np.linalg.qr(np.eye(3) - 0.4j * (a + a.conj().T))
    args, kwargs = _gate_args()
    return (args[:6] + ([0],), dict(kwargs, U0=U0))


# name: (loss, problem, reg_coeffs, extra channel, (fid/reg atol, grad atol))
# -- the cases of tests/test_xla_batch.py and test_parallel.py
LOSSES = {
    "cols_extras_reg": ("cols", lambda: _leakage_args(levels=5),
                        {"amplitude": 0.1, "dwdt": 0.01}, True, (1e-5, 2e-5)),
    "pallas_extras_reg": ("pallas", lambda: _leakage_args(levels=5),
                          {"amplitude": 0.1, "dwdt": 0.01}, True,
                          (1e-5, 2e-5)),
    "cols_forbidden": ("cols", lambda: _leakage_args(levels=5), {
        "forbidden_coeff_list": [6.0, 3.0], "states_forbidden_list": [2, 3],
        "amplitude": 0.05}, False, (1e-5, 2e-5)),
    "cols_forbidden_dressed": ("cols", _dressed_args, {
        "forbidden_coeff_list": [5.0], "states_forbidden_list": [3],
        "forbid_dressed": True}, False, (1e-5, 2e-5)),
    "cols_speed_up_state": ("cols", lambda: _leakage_args(levels=5),
                            {"speed_up": 0.05, "amplitude": 0.02}, False,
                            (1e-4, 2e-4)),
    "cols_speed_up_unitary": ("cols", _gate_u0_args, {"speed_up": 0.1},
                              False, (1e-4, 2e-4)),
    "cols_v12": ("cols", _v12_args, None, False, (1e-5, 1e-5)),
    "cols_unitary_scaling": ("cols", _gate_u0_args, None, False,
                             (1e-5, 2e-5)),
    "pallas_unitary_v2": ("pallas", _gate_args, {"amplitude": 0.1}, False,
                          (1e-5, 2e-5)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_batched_loss_matches_qoc_tpu(name):
    """Per-seed fidelity and regularized losses and the gradient of their
    sum, against qoc_tpu's loss of the same backend (test_xla_batch.py's
    tolerances: 1e-5 on values and 2e-5 on gradients, 1e-4 and 2e-4 with
    speed_up)."""
    kind, make, rc, extra, (tol, gtol) = LOSSES[name]
    jp, tp = _problems(make)
    S = 3
    u = _u0(jp, S, seed=1)
    em = ew = None
    if extra:
        em = np.stack([q.c_to_r_mat(-1j * jp.dt * np.diag(
            np.arange(jp.state_num, dtype=float)))]).astype(np.float32)
        ew = np.linspace(-0.2, 0.2, S)[:, None].astype(np.float32)
    j_make, t_make = ((j_cols_loss, make_xla_batched_loss) if kind == "cols"
                      else (j_pallas_loss, make_pallas_batched_loss))
    jl = j_make(jp, rc, extra_channel_mats=em)
    jew = None if ew is None else jnp.asarray(ew)
    jreg, jfid = jl(jnp.asarray(u), jew)
    jg = jax.grad(lambda x: jnp.sum(jl(x, jew)[0]))(jnp.asarray(u))
    tl = t_make(tp, rc, extra_channel_mats=em)
    ut = torch.tensor(u, requires_grad=True)
    treg, tfid = tl(ut, None if ew is None else torch.tensor(ew))
    (tg,) = torch.autograd.grad(treg.sum(), ut)
    np.testing.assert_allclose(tfid.detach().numpy(), np.asarray(jfid),
                               atol=tol)
    np.testing.assert_allclose(treg.detach().numpy(), np.asarray(jreg),
                               atol=tol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=gtol)


# name: (problem, backend, reg_coeffs, seeds, mats_b kind)
RUNS = {
    "xla": (_pi_args, "xla", {"amplitude": 0.1}, 3, None),
    "xla_mats_batch_sweep": (_pi_args, "xla", None, 3, "sweep"),
    "xla_cols": (_leakage_args, "xla-cols",
                 {"forbidden_coeff_list": [4.0], "states_forbidden_list": [2],
                  "amplitude": 0.05}, 3, None),
    "xla_cols_unitary_v2": (_gate_args, "xla-cols", {"speed_up": 0.1}, 2,
                            None),
    "pallas": (_pi_args, "pallas", {"amplitude": 0.1, "dwdt": 0.01}, 3,
               "extra"),
    "mega": (_pi_args, "mega", {"amplitude": 0.1, "dwdt": 0.01}, 3, None),
}


def _run_pair(name, n=N_ITERS):
    make, backend, rc, S, kind = RUNS[name]
    jp, tp = _problems(make)
    u0 = _u0(jp, S)
    extra = mats_b = None
    if kind == "sweep":
        mats_b = _detuning_sweep(jp, S)
    elif kind == "extra":
        extra, mats_b = _extra_channel(jp, S)
    ji, jr = jbatch.make_batched_runner(
        jp, ConvergenceSettings.from_dict(CONV), reg_coeffs=rc,
        sweep_mats=kind == "sweep", backend=backend,
        extra_channel_mats=extra)
    want = jr(ji(jnp.asarray(u0)), jnp.asarray(n, dtype=jnp.int32),
              None if mats_b is None else jnp.asarray(mats_b))
    ti, tr = make_batched_runner(
        tp, TConv.from_dict(CONV), reg_coeffs=rc, sweep_mats=kind == "sweep",
        backend=backend, extra_channel_mats=extra, device="cpu")
    got = tr(ti(u0), n, None if mats_b is None else torch.tensor(mats_b))
    return got, want


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_matches_qoc_tpu_backend(name):
    """20 iterations from the same pulses: u within 5e-5, losses and
    reg_losses within 2e-5, grad^2 within 2e-3 relative
    (tests/test_mega_batch.py's and test_torch_mega.py's tolerances)."""
    got, want = _run_pair(name)
    assert got.iteration == int(want.iteration) == N_ITERS
    np.testing.assert_allclose(got.u_base.numpy(), np.asarray(want.u_base),
                               atol=5e-5)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               atol=2e-5)
    np.testing.assert_allclose(got.reg_loss.numpy(),
                               np.asarray(want.reg_loss), atol=2e-5)
    np.testing.assert_allclose(got.grad_squared.numpy(),
                               np.asarray(want.grad_squared), rtol=2e-3)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))


def _fixed_seeds(monkeypatch, U):
    monkeypatch.setattr(jbatch, "init_seeds",
                        lambda problem, n, key: jnp.asarray(U))
    monkeypatch.setattr(tbatch, "init_seeds",
                        lambda problem, n, generator, device: torch.tensor(
                            U).to(device))


@pytest.mark.parametrize("extra", [False, True], ids=["xla", "extra_mega"])
def test_batched_grape_adam_matches_qoc_tpu(extra, monkeypatch):
    """qoc_tpu's result dict, key for key, from the same initial pulses:
    the CPU auto ladder (xla), and extra channels (routed to mega by both
    packages)."""
    jp, tp = _problems(_pi_args)
    U = _u0(jp, 3, seed=7)
    _fixed_seeds(monkeypatch, U)
    conv = {"rate": 0.05, "update_step": 10, "max_iterations": 30,
            "conv_target": 1e-3}
    kw = dict(convergence=conv, seed=0)
    if extra:
        kw["extra_channels"] = _extra_channel(jp, 3)
    want = jbatch.batched_grape_adam(jp, n_seeds=3, **kw)
    got = batched_grape_adam(tp, n_seeds=3, device="cpu", **kw)
    assert set(got) == set(want)
    assert got["iterations"] == want["iterations"]
    assert got["best_seed"] == want["best_seed"]
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["losses"], want["losses"], atol=2e-5)
    np.testing.assert_allclose(got["reg_losses"], want["reg_losses"],
                               atol=2e-5)
    np.testing.assert_allclose(got["u_base"], want["u_base"], atol=5e-5)
    np.testing.assert_allclose(got["uks"], want["uks"], atol=5e-5)
    np.testing.assert_allclose(got["best_uks"], want["best_uks"], atol=5e-5)
    assert abs(got["best_loss"] - want["best_loss"]) < 2e-5


def test_per_iteration_state_carries_across_from_qoc_tpu():
    """10 xla iterations in qoc_tpu, its vmapped optax state into the port,
    10 more in the port == qoc_tpu's 20; and the leaves back."""
    jp, tp = _problems(_pi_args)
    u0 = _u0(jp, 3)
    rc = {"amplitude": 0.1}
    ji, jr = jbatch.make_batched_runner(
        jp, ConvergenceSettings.from_dict(CONV), reg_coeffs=rc,
        backend="xla")
    half = jr(ji(jnp.asarray(u0)), jnp.asarray(N_ITERS // 2, jnp.int32), None)
    want = jr(ji(jnp.asarray(u0)), jnp.asarray(N_ITERS, jnp.int32), None)
    adam, decay = half.opt_state[0], half.opt_state[1]
    st = batch_state_from_numpy(half.u_base, adam.mu, adam.nu, adam.count,
                                decay["lr"], iteration=int(half.iteration),
                                done=half.done)
    _, tr = make_batched_runner(tp, TConv.from_dict(CONV), reg_coeffs=rc,
                                backend="xla", device="cpu")
    got = tr(st, N_ITERS, None)
    np.testing.assert_allclose(got.u_base.numpy(), np.asarray(want.u_base),
                               atol=5e-5)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               atol=2e-5)
    u, mu, nu, count, lr = batch_state_to_numpy(got)
    np.testing.assert_array_equal(count, np.asarray(want.opt_state[0].count))
    np.testing.assert_allclose(lr, np.asarray(want.opt_state[1]["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(mu, np.asarray(want.opt_state[0].mu),
                               atol=1e-5)


def _gate_problems():
    """Problems of tests/test_parallel.py and test_xla_batch.py."""
    a = q.annihilate(3)
    U0, _ = np.linalg.qr(np.eye(3) - 0.4j * (a + a.conj().T))
    unitary = _gate_args()
    return [_pi_args(), _pi_args(steps=3), _leakage_args(),
            _leakage_args(levels=5), unitary,
            (unitary[0], dict(unitary[1], U0=U0)),
            ((np.zeros((2, 2), dtype=complex),
              [q.SIGMA_X, q.SIGMA_Y, q.SIGMA_Z], ["x", "y", "z"],
              q.hadamard(1), 6.0, 30, [0, 1]),
             dict(maxA=[1.0] * 3, seed=0, no_scaling=True)),
            _pi_args(use_inter_vecs=False)]


GATE_RC = [None, {"amplitude": 0.1, "dwdt": 0.01}, {"speed_up": 0.1},
           {"forbidden_coeff_list": [1.0], "states_forbidden_list": [1]}]


@pytest.mark.parametrize("rc", GATE_RC, ids=["none", "pulse", "speed_up",
                                             "forbidden"])
def test_gates_and_reasons_match_qoc_tpu(rc):
    for args, kwargs in _gate_problems():
        jp = ControlProblem.build(*args, **kwargs)
        tp = TorchProblem.build(*args, **kwargs)
        assert pallas_batch_supported(tp, rc) == j_pallas_supported(jp, rc)
        assert xla_cols_supported(tp, rc) == j_cols_supported(jp, rc)
        for sweep in (False, True):
            for on_accel in (False, True):
                got = fused_fallback_reasons(tp, rc, "exact",
                                             sweep_mats=sweep,
                                             on_accel=on_accel)
                want = j_reasons(jp, rc, "exact", sweep_mats=sweep,
                                 on_accel=on_accel)
                assert len(got) == len(want), (got, want)
                for key in ("V=", "use_inter_vecs", "mats_batch", "cpu"):
                    assert (any(key in r for r in got)
                            == any(key in r for r in want)), (key, got, want)


def test_init_seeds():
    _, tp = _problems(lambda: _pi_args(steps=60))
    a = init_seeds(tp, 16, torch.Generator().manual_seed(5))
    b = init_seeds(tp, 16, torch.Generator().manual_seed(5))
    c = init_seeds(tp, 16, torch.Generator().manual_seed(6))
    assert a.shape == (16, 2, 60) and a.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not torch.equal(a, c)
    assert abs(float(a.mean())) < 0.2 / np.sqrt(60)
    assert np.isclose(float(a.std()), 1 / np.sqrt(60), rtol=0.2)


def test_routing_lines(capsys):
    """One line per run naming the backend; CUDA wording for the kernels,
    the costs instance naming its penalties, and the fallback reasons
    when kernel 6 is passed over."""
    _, tp = _problems(_leakage_args)
    rc = {"forbidden_coeff_list": [4.0], "states_forbidden_list": [2],
          "dwdt": 0.01}
    cuda = torch.device("cuda")
    assert describe_backend("mega", cuda, rc) == (
        "mega (fused batched-optimizer CUDA kernel, penalties: forbidden, "
        "dwdt)")
    assert describe_backend("mega", cuda) == (
        "mega (fused batched-optimizer CUDA kernel)")
    assert describe_backend("pallas", cuda) == (
        "pallas (fused state-chain CUDA kernel + autograd backward)")
    make_batched_runner(tp, TConv.from_dict(CONV), reg_coeffs=rc,
                        device="cpu")
    make_batched_runner(tp, TConv.from_dict(CONV), reg_coeffs=rc,
                        backend="mega", device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [
        "[qoc-tpu-torch] batch backend: xla (vmapped generic forward) "
        "(fallback: cpu device (the fused kernels need a CUDA device))",
        "[qoc-tpu-torch] batch backend: mega (plain torch batched segment "
        "on cpu, penalties: forbidden, dwdt) (forced)"]

