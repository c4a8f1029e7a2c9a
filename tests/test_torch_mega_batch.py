"""The port's fused batched-optimizer segment (plain torch version on the
CPU) against qoc_tpu: 20 iterations with and without penalties, extra
channels and per-seed freezing, with tests/test_mega_batch.py's problems
and tolerances; segment composition; a MegaBatchState carried across from
qoc_tpu; the admission gate; and qoc_tpu's grad^2 quirk, which the port
does not carry over.  The two-level cases run against qoc_tpu's Pallas
kernel 6 (interpreted, as qoc_tpu's own tests run it); the three-level
cases against qoc_tpu's column-batched XLA backend, which computes the
same segment and compiles in a fraction of the interpreted kernel's
time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.optim.convergence import ConvergenceSettings
from qoc_tpu.parallel.batch import make_batched_runner as j_batched_runner
from qoc_tpu.parallel.pallas_mega_batch import MegaBatchState as JMegaState
from qoc_tpu.parallel.pallas_mega_batch import (
    batched_mega_supported as j_supported)
from qoc_tpu.parallel.pallas_mega_batch import (
    make_mega_batched_runner as j_runner)
from qoc_tpu_torch.interop import (
    mega_batch_state_from_numpy, mega_batch_state_to_numpy)
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem
from qoc_tpu_torch.optim.convergence import ConvergenceSettings as TConv
from qoc_tpu_torch.parallel.mega_batch import (
    batched_mega_supported, make_mega_batched_runner)

torch.set_num_threads(1)

N_ITERS = 20


def _pi_args(steps=16):
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 2.0, steps,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[0.7, 0.7], seed=0))


def _v2_state_args():
    psi0s = [np.array([1, 0], dtype=complex), np.array([0, 1], dtype=complex)]
    tgts = [np.array([0, 1], dtype=complex), np.array([1, 0], dtype=complex)]
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], tgts, 2.0, 16, psi0s),
            dict(state_transfer=True, maxA=[0.7, 0.7], seed=0))


def _leakage_args(steps=16):
    n = 3
    a = q.annihilate(n)
    psi0 = np.zeros(n, complex)
    psi0[0] = 1
    tgt = np.zeros(n, complex)
    tgt[1] = 1
    return ((np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
             [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt], 2.0,
             steps, [psi0]),
            dict(state_transfer=True, maxA=[0.5, 0.5], seed=0))


def _ladder_gate_args(**over):
    """The 3-level ladder's X gate, V = 2 (chip_smoke.py's ladder, T=16)."""
    a = q.annihilate(3)
    kw = dict(maxA=[0.5, 0.5], seed=0)
    kw.update(over)
    return ((np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
             [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             q.transmon_gate(q.SIGMA_X, 3), 3.0, 16, [0, 1]), kw)


def _conv(**over):
    base = {"rate": 0.01, "update_step": 10, "max_iterations": 100,
            "conv_target": 1e-12}
    base.update(over)
    return base


def _detuning(p):
    return np.stack([np.asarray(q.c_to_r_mat(
        -1j * (p.total_time / p.steps) * np.diag([0.0, 1.0])))]).astype(
            np.float32)


# name: (problem args, reg_coeffs, convergence, seeds, extra channel,
#        qoc_tpu reference: its kernel 6, or its xla-cols backend)
CASES = {
    "fidelity": (_pi_args, None, _conv(), 4, False, "kernel"),
    "extra_channels": (_pi_args, None, _conv(), 3, True, "kernel"),
    "per_seed_freeze": (_pi_args, None, _conv(rate=0.05, conv_target=0.12),
                        6, False, "kernel"),
    "v2_state_transfer": (_v2_state_args, None, _conv(), 4, False, "kernel"),
    "pulse_costs": (_pi_args, {"amplitude": 0.3, "envelope": 0.2,
                               "dwdt": 0.05, "d2wdt2": 0.001,
                               "bandpass": 0.1, "band": [0.1, 3.0]},
                    _conv(), 4, False, "kernel"),
    "speed_up": (_pi_args, {"speed_up": 0.05, "amplitude": 0.02}, _conv(),
                 3, False, "kernel"),
    "forbidden": (_leakage_args, {"forbidden_coeff_list": [4.0],
                                  "states_forbidden_list": [2]},
                  _conv(), 3, False, "xla-cols"),
    "bandpass": (_leakage_args, {"bandpass": 0.5, "band": [0.5, 2.0]},
                 _conv(), 3, False, "xla-cols"),
    "forbidden_pulse": (_leakage_args, {
        "forbidden_coeff_list": [5.0], "states_forbidden_list": [2],
        "dwdt": 0.01, "amplitude": 0.05}, _conv(), 2, False, "xla-cols"),
}


def _case(name):
    make, rc, conv, S, extra, _ = CASES[name]
    args, kwargs = make()
    jp = ControlProblem.build(*args, **kwargs)
    tp = TorchProblem.build(*args, **kwargs)
    rng = np.random.default_rng(3)
    u0 = (rng.standard_normal((S, jp.ops_len, jp.steps)) / 4).astype(
        np.float32)
    em = ew = None
    if extra:
        em = _detuning(jp)
        ew = np.linspace(-0.5, 0.3, S)[:, None].astype(np.float32)
    return jp, tp, rc, conv, u0, em, ew


@pytest.fixture(scope="module")
def qoc_tpu_segments():
    """qoc_tpu's N_ITERS iterations per case (computed once), as (u [S, Kc,
    T], losses, reg_losses, grad^2 (the true seed norm), it, done)."""
    cache = {}

    def get(name):
        if name not in cache:
            jp, _, rc, conv, u0, em, ew = _case(name)
            settings = ConvergenceSettings.from_dict(conv)
            if CASES[name][5] == "kernel":
                init, run, read = j_runner(jp, settings,
                                           extra_channel_mats=em,
                                           reg_coeffs=rc)
                st = run(init(u0), N_ITERS, extra_weights=ew)
                V = jp.initial_vectors.shape[1]
                # qoc_tpu's kernel reports grad^2 / V
                # (pallas_mega_batch.py:528-529)
                cache[name] = (read(st), np.asarray(st.losses),
                               np.asarray(st.reg_losses),
                               V * np.asarray(st.grad_squared),
                               np.asarray(st.it_cols)[0, ::V],
                               np.asarray(st.done_cols)[0, ::V] > 0.5)
            else:
                init, run = j_batched_runner(jp, settings, reg_coeffs=rc,
                                             backend="xla-cols")
                st = run(init(jnp.asarray(u0)),
                         jnp.asarray(N_ITERS, dtype=jnp.int32), None)
                cache[name] = (np.asarray(st.u_base), np.asarray(st.loss),
                               np.asarray(st.reg_loss),
                               np.asarray(st.grad_squared),
                               np.full(len(u0), N_ITERS),
                               np.asarray(st.done))
        return cache[name]

    return get


def _port_runner(name):
    _, tp, rc, conv, u0, em, ew = _case(name)
    init, run, read = make_mega_batched_runner(
        tp, TConv.from_dict(conv), extra_channel_mats=em, reg_coeffs=rc,
        device="cpu")
    return init, run, read, u0, ew, tp.initial_vectors.shape[1]


@pytest.mark.parametrize("name", list(CASES))
def test_segment_matches_qoc_tpu(name, qoc_tpu_segments):
    """u within 5e-5, losses and reg_losses within 2e-5 (test_mega_batch
    tolerances), grad^2 within 2e-3 relative, it and done equal."""
    u, losses, regs, g2, its, done = qoc_tpu_segments(name)
    init, run, read, u0, ew, V = _port_runner(name)
    got = run(init(u0), N_ITERS, extra_weights=ew)
    np.testing.assert_allclose(read(got), u, atol=5e-5)
    np.testing.assert_allclose(got.losses.numpy(), losses, atol=2e-5)
    np.testing.assert_allclose(got.reg_losses.numpy(), regs, atol=2e-5)
    np.testing.assert_allclose(got.grad_squared.numpy(), g2, rtol=2e-3)
    np.testing.assert_array_equal(got.it_cols.numpy()[0, ::V], its)
    np.testing.assert_array_equal(got.done_cols.numpy()[0, ::V] > 0.5, done)
    if name == "per_seed_freeze":
        its = got.it_cols.numpy()[0]
        assert (its < N_ITERS).all() and len(set(its.tolist())) > 1
    if CASES[name][1]:
        assert np.all(got.reg_losses.numpy() - got.losses.numpy() > 1e-6)


@pytest.mark.parametrize("name", ["fidelity", "forbidden_pulse"])
def test_segments_compose(name):
    init, run, read, u0, ew, _ = _port_runner(name)
    whole = run(init(u0), N_ITERS, extra_weights=ew)
    half = run(run(init(u0), N_ITERS // 2, extra_weights=ew), N_ITERS // 2,
               extra_weights=ew)
    assert half.iteration == whole.iteration == N_ITERS
    np.testing.assert_allclose(read(half), read(whole), atol=1e-6)
    np.testing.assert_array_equal(half.it_cols.numpy(),
                                  whole.it_cols.numpy())
    np.testing.assert_allclose(half.losses.numpy(), whole.losses.numpy(),
                               atol=1e-7)


@pytest.mark.parametrize("name", ["fidelity", "per_seed_freeze"])
def test_state_carries_across_from_qoc_tpu(name, qoc_tpu_segments):
    """N_ITERS/2 iterations in qoc_tpu, its MegaBatchState into the port,
    N_ITERS/2 more in the port == qoc_tpu's N_ITERS; and back."""
    jp, _, rc, conv, u0, em, ew = _case(name)
    init, run, _ = j_runner(jp, ConvergenceSettings.from_dict(conv),
                            reg_coeffs=rc)
    half = run(init(u0), N_ITERS // 2)
    st = mega_batch_state_from_numpy(half)
    assert st.iteration == N_ITERS // 2
    _, t_run, read, _, _, V = _port_runner(name)
    got = t_run(st, N_ITERS // 2)
    u, losses, _, _, its, _ = qoc_tpu_segments(name)
    np.testing.assert_allclose(read(got), u, atol=5e-5)
    np.testing.assert_allclose(got.losses.numpy(), losses, atol=2e-5)
    np.testing.assert_array_equal(got.it_cols.numpy()[0, ::V], its)

    back = JMegaState(**mega_batch_state_to_numpy(got))
    np.testing.assert_array_equal(np.asarray(back.u_cols), got.u_cols.numpy())
    assert back.iteration == N_ITERS
    cont = run(back, 1)     # qoc_tpu continues from the port's state
    assert int(np.asarray(cont.it_cols).max()) <= N_ITERS + 1


GATE_RC = {
    "none": None,
    "pulse": {"amplitude": 0.1, "envelope": 0.2, "d2wdt2": 0.01},
    "bandpass": {"bandpass": 0.1, "band": [0.1, 3.0]},
    "bandpass_without_band": {"bandpass": 0.1},
    "speed_up": {"speed_up": 0.1},
    "forbidden": {"forbidden_coeff_list": [4.0], "states_forbidden_list": [1]},
    "unknown_key": {"not_a_cost": 0.1},
    "dwdt": {"dwdt": 0.1},
}


def _gate_problems():
    """The problems of tests/test_mega_batch.py, test_parallel.py and
    test_xla_batch.py (V from 1 to 12, M from 4 to 32, steps from 3)."""
    cnot = np.eye(4, dtype=complex)
    cnot[2:, 2:] = [[0, 1], [1, 0]]
    XI = np.kron(q.SIGMA_X, np.eye(2))
    IX = np.kron(np.eye(2), q.SIGMA_X)
    ZZ = np.kron(q.SIGMA_Z, q.SIGMA_Z)
    a5 = q.annihilate(5)
    rng = np.random.default_rng(0)
    A_ = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    H16 = (A_ + A_.conj().T) / 8
    Hop = np.diag(np.arange(16, dtype=float)) / 4
    U16 = np.eye(16, dtype=complex)
    U16[:2, :2] = [[0, 1], [1, 0]]
    pi_short = _pi_args(steps=3)
    out = [_pi_args(), pi_short, _v2_state_args(), _leakage_args(),
           _ladder_gate_args(), _ladder_gate_args(Taylor_terms=[8, 2]),
           ((np.zeros((4, 4), dtype=complex), [XI, IX, ZZ], ["xi", "ix", "zz"],
             cnot, 4.0, 12, [0, 1, 2, 3]),
            dict(maxA=[1.0] * 3, seed=0, Taylor_terms=[8, 2])),
           ((2 * np.pi * (-0.2) / 2 * (a5.conj().T @ a5.conj().T @ a5 @ a5),
             [a5 + a5.conj().T, 1j * (a5 - a5.conj().T)], ["x", "y"],
             [np.eye(5)[1].astype(complex)], 3.0, 12,
             [np.eye(5)[0].astype(complex)]),
            dict(state_transfer=True, maxA=[1.0, 1.0], seed=0)),
           ((H16, [Hop, H16 @ Hop - Hop @ H16 + np.eye(16)], ["a", "b"], U16,
             4.0, 10, list(range(12))),
            dict(maxA=[1.0, 1.0], seed=0, Taylor_terms=[8, 1])),
           (_pi_args()[0], dict(_pi_args()[1], use_inter_vecs=False))]
    return out


@pytest.mark.parametrize("case", list(GATE_RC))
def test_batched_mega_supported_matches_qoc_tpu(case):
    rc = GATE_RC[case]
    for args, kwargs in _gate_problems():
        jp = ControlProblem.build(*args, **kwargs)
        tp = TorchProblem.build(*args, **kwargs)
        assert batched_mega_supported(tp, rc) == j_supported(jp, rc), (
            args[5], jp.initial_vectors.shape, rc)


def test_cuda_bounds_replace_the_vmem_budget():
    """A problem outside the CUDA kernel's compiled dimensions is refused
    whatever qoc_tpu's VMEM budget says."""
    n = 8   # M = 16, not one of the kernels' M
    a = q.annihilate(n)
    tp = TorchProblem.build(np.zeros((n, n), complex), [a + a.conj().T],
                            ["x"], [np.eye(n)[1].astype(complex)], 2.0, 8,
                            [np.eye(n)[0].astype(complex)],
                            state_transfer=True, maxA=[0.5], seed=0)
    assert not batched_mega_supported(tp)


def _quirk_problem():
    """The table of the port's notes: ladder X gate, V = 2, T = 16, 4 seeds
    of standard_normal / 4 from default_rng(0)."""
    args, kwargs = _ladder_gate_args()
    return (ControlProblem.build(*args, **kwargs),
            TorchProblem.build(*args, **kwargs))


def test_grad_squared_is_the_true_seed_norm():
    """qoc_tpu's fused kernel multiplies each seed's grad^2 by 1/V
    (qoc_tpu/parallel/pallas_mega_batch.py:528-529: "replicas each counted
    the full seed norm", though g is already the group-summed gradient).
    The port's kernel-6 plain version reports the true norm: equal to
    qoc_tpu's "xla" backend and to V x qoc_tpu's fused kernel, rtol 1e-5;
    the losses agree with both."""
    jp, tp = _quirk_problem()
    u = (np.random.default_rng(0).standard_normal((4, 2, 16)) / 4).astype(
        np.float32)
    conv = _conv()
    init, run, _ = make_mega_batched_runner(tp, TConv.from_dict(conv),
                                            device="cpu")
    got = run(init(u), 1)
    ji, jr, _ = j_runner(jp, ConvergenceSettings.from_dict(conv))
    mega = jr(ji(u), 1)
    xi, xr = j_batched_runner(jp, ConvergenceSettings.from_dict(conv),
                              backend="xla")
    xla = xr(xi(jnp.asarray(u)), jnp.asarray(1, dtype=jnp.int32), None)
    g2 = got.grad_squared.numpy()
    np.testing.assert_allclose(g2, np.asarray(xla.grad_squared), rtol=1e-5)
    np.testing.assert_allclose(g2, 2 * np.asarray(mega.grad_squared),
                               rtol=1e-5)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(mega.losses),
                               atol=2e-6)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(xla.loss),
                               atol=2e-6)


def test_min_grad_freezes_where_qoc_tpu_xla_does():
    """With min_grad, each seed freezes at the iteration where qoc_tpu's
    "xla" backend freezes it (38, 0, 0, 9 here, two of them mid-run).
    (qoc_tpu's fused kernel, testing grad^2 / V, freezes seeds 0 and 3
    earlier.)"""
    jp, tp = _quirk_problem()
    u = (np.random.default_rng(0).standard_normal((4, 2, 16)) / 1.5).astype(
        np.float32)
    conv = _conv(rate=0.05, min_grad=2e-3)
    n = 40
    xi, xr = j_batched_runner(jp, ConvergenceSettings.from_dict(conv),
                              backend="xla")
    st = xi(jnp.asarray(u))
    frozen_at = np.full(4, n)
    for k in range(1, n + 1):
        st = xr(st, jnp.asarray(k, dtype=jnp.int32), None)
        newly = np.asarray(st.done) & (frozen_at == n)
        frozen_at[newly] = k - 1
    init, run, _ = make_mega_batched_runner(tp, TConv.from_dict(conv),
                                            device="cpu")
    got = run(init(u), n)
    np.testing.assert_array_equal(got.it_cols.numpy()[0, ::2], frozen_at)
    assert (frozen_at < n).all() and len(set(frozen_at.tolist())) == 3


@pytest.mark.parametrize("rc", [None, {"forbidden_coeff_list": [5.0],
                                        "states_forbidden_list": [2],
                                        "dwdt": 0.01}],
                         ids=["fidelity", "costs"])
def test_off_the_cpu_never_falls_back(rc):
    """A problem held off the CPU goes to the CUDA launcher, which refuses
    anything but CUDA float32 operands instead of running the plain
    version."""
    args, kwargs = _leakage_args()
    tp = TorchProblem.build(*args, **kwargs)
    init, run, _ = make_mega_batched_runner(tp, TConv.from_dict(_conv()),
                                            reg_coeffs=rc, device="meta")
    u0 = np.zeros((2, 2, 16), np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        run(init(u0), 3)


def test_device_none_is_the_card(monkeypatch):
    """make_mega_batched_runner defaults to the card, as batched_grape_adam
    does, and raises without one instead of running the plain version."""
    args, kwargs = _leakage_args()
    tp = TorchProblem.build(*args, **kwargs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None runs on the CUDA"):
        make_mega_batched_runner(tp, TConv.from_dict(_conv()))
