"""The port's copy of qoc_tpu's verification (four oracles) and qutip shim,
pinned bit for bit to the originals on the same inputs and the same h5
run file, as tests/test_torch_frontend.py pins the front end."""

import sys

import numpy as np
import pytest
import torch

import qoc_tpu_torch as qt
from qoc_tpu.utils import qutip_shim as qoc_shim
from qoc_tpu.utils import verification as qoc_ver
from qoc_tpu_torch.utils import qutip_shim
from qoc_tpu_torch.utils import verification

torch.set_num_threads(1)


def _random_problem(n=3, K=2, steps=12, seed=5):
    """(H0, Hops, uks, total_time, steps, psi0): Hermitian H0 and H_k and a
    random pulse, made with numpy from a seed."""
    rng = np.random.default_rng(seed)

    def herm():
        h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (h + h.conj().T) / 2

    psi0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (herm(), [herm() for _ in range(K)],
            rng.standard_normal((K, steps)), 1.5, steps,
            psi0 / np.linalg.norm(psi0))


def test_scipy_and_ode_oracles_bit_identical():
    args = _random_problem()
    np.testing.assert_array_equal(verification.scipy_oracle_states(*args),
                                  qoc_ver.scipy_oracle_states(*args))
    np.testing.assert_array_equal(verification.ode_oracle_states(*args),
                                  qoc_ver.ode_oracle_states(*args))


def test_piecewise_uks_fns_bit_identical():
    _, _, uks, total_time, steps, _ = _random_problem()
    got = verification.piecewise_uks_fns(uks, total_time, steps)
    want = qoc_ver.piecewise_uks_fns(uks, total_time, steps)
    ts = np.linspace(0.0, total_time, 4 * steps + 3)
    assert len(got) == len(want) == uks.shape[0]
    for g, w in zip(got, want):
        assert [g(t) for t in ts] == [w(t) for t in ts]


def test_qutip_branch_on_the_shims_bit_identical():
    """``_qutip_states`` through each package's qutip shim."""
    args = _random_problem()
    got = verification._qutip_states(*args, qt=qutip_shim)
    want = qoc_ver._qutip_states(*args, qt=qoc_shim)
    np.testing.assert_array_equal(got, want)
    # and the shim's states follow the independent Pade oracle
    np.testing.assert_allclose(got, verification.scipy_oracle_states(*args),
                               atol=1e-6)


def test_qutip_oracle_without_qutip_raises_in_both(monkeypatch):
    monkeypatch.setitem(sys.modules, "qutip", None)
    args = _random_problem()
    errors = []
    for mod in (verification, qoc_ver):
        with pytest.raises(ImportError, match="optional qutip extra") as e:
            mod._qutip_states(*args)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


@pytest.fixture(scope="module")
def run_file(tmp_path_factory):
    """An h5 run the port wrote: the pi pulse (T = 40) and a 3-level gate
    with two initial vectors."""
    path = tmp_path_factory.mktemp("runs")
    conv = {"rate": 0.02, "update_step": 10, "max_iterations": 20,
            "conv_target": 1e-8}
    res = qt.Grape(np.zeros((2, 2), dtype=complex), [qt.SIGMA_X, qt.SIGMA_Y],
                   ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 40,
                   [np.array([1, 0], dtype=complex)], state_transfer=True,
                   maxA=[0.7, 0.7], seed=0, convergence=conv,
                   show_plots=False, file_name="pi", data_path=str(path),
                   device="cpu")
    a = qt.annihilate(3)
    gate = qt.Grape(np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
                    [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
                    qt.transmon_gate(qt.SIGMA_X, 3), 3.0, 30, [0, 1],
                    maxA=[0.5, 0.5], seed=0, convergence=conv,
                    show_plots=False, file_name="gate", data_path=str(path),
                    device="cpu")
    return {"pi": res.file_path, "gate": gate.file_path}


@pytest.mark.parametrize("oracle", ["scipy", "ode", "qutip-shim"])
@pytest.mark.parametrize("name", ["pi", "gate"])
def test_verify_run_bit_identical(run_file, name, oracle):
    got = verification.verify_run(run_file[name], atol=1e-3, oracle=oracle)
    want = qoc_ver.verify_run(run_file[name], atol=1e-3, oracle=oracle)
    assert got == want
    assert all(got["all_close"])
    assert len(got["all_close"]) == (1 if name == "pi" else 2)


def test_qutip_verification_falls_back_to_ode_in_both(run_file, monkeypatch,
                                                      capsys):
    monkeypatch.setitem(sys.modules, "qutip", None)
    got = verification.qutip_verification(run_file["pi"], 1e-3)
    got_out = capsys.readouterr().out
    want = qoc_ver.qutip_verification(run_file["pi"], 1e-3)
    assert got == want
    assert got_out == capsys.readouterr().out
    assert "(ode oracle)" in got_out


def test_shim_qobj_and_sesolve_bit_identical():
    H0, Hops, uks, total_time, steps, psi0 = _random_problem(n=4, K=1)
    for mod in (qutip_shim, qoc_shim):
        q = mod.Qobj(psi0)
        assert q.shape == (4, 1)
    fns = verification.piecewise_uks_fns(uks, total_time, steps)
    tlist = np.linspace(0, total_time, steps + 1)
    got = qutip_shim.sesolve([qutip_shim.Qobj(H0), [Hops[0], fns[0]]],
                             qutip_shim.Qobj(psi0), tlist)
    want = qoc_shim.sesolve([qoc_shim.Qobj(H0), [Hops[0], fns[0]]],
                            qoc_shim.Qobj(psi0), tlist)
    assert len(got.states) == len(want.states) == steps + 1
    for a, b in zip(got.states, want.states):
        np.testing.assert_array_equal(a.full(), b.full())
