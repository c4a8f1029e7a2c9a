"""The port's copied numpy front end against qoc_tpu's original: problem
preprocessing, Taylor choice, gates, operators and the isomorphism must
agree bit for bit, and importing the port must not import jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu_torch as qt
from qoc_tpu.cli import load_config
from qoc_tpu.models.system import ControlProblem
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pi_pulse(steps=64):
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, steps,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[2 * np.pi * 0.1] * 2, seed=0))


def _gate(steps=24):
    """tests/test_mega.py's unitary problem: Taylor [6, 2] (squaring)."""
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], q.SIGMA_X, 2.0, steps, [0, 1]),
            dict(maxA=[1.0, 1.0], seed=1, Taylor_terms=[6, 2]))


def _cnot(steps=64):
    cfg = load_config(os.path.join(REPO, "examples", "jobs", "cnot.json"))
    return ((cfg["H0"], cfg["Hops"], cfg["Hnames"], cfg["U"],
             cfg["total_time"], steps, cfg["states_concerned_list"]),
            dict(maxA=cfg["maxA"], seed=cfg["seed"]))


def _dressed(steps=48):
    """A dressed 3-level transmon gate (tests/test_mega.py)."""
    H0 = np.array([[0.0, 0.05, 0.0], [0.05, 1.0, 0.05], [0.0, 0.05, 2.2]],
                  dtype=complex)
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    dinfo = {"eigenvectors": v_c, "eigenvalues": np.real(w_c),
             "dressed_id": dressed_id, "is_dressed": True}
    a = q.annihilate(3)
    return ((H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             q.transmon_gate(q.SIGMA_X, 3), 8.0, steps, [0, 1]),
            dict(dressed_info=dinfo, maxA=[2.0, 2.0], seed=0))


@pytest.mark.parametrize("make", [_pi_pulse, _gate, _cnot, _dressed],
                         ids=["pi_pulse", "gate_taylor62", "cnot", "dressed"])
def test_control_problem_bit_identical(make):
    args, kwargs = make()
    ref = ControlProblem.build(*args, **kwargs)
    got = TorchProblem.build(*args, **kwargs)
    assert got.taylor_terms == ref.taylor_terms
    assert got.taylor_scaling == ref.taylor_scaling
    for f in dataclasses.fields(ControlProblem):
        _assert_same(getattr(got, f.name), getattr(ref, f.name), f.name)


def _assert_same(a, b, name):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            _assert_same(x, y, name)
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), name
        for k in b:
            _assert_same(a[k], b[k], name)
    else:
        assert a == b, name


def test_taylor_choice_matches():
    from qoc_tpu.ops.taylor import choose_taylor_terms as ref
    from qoc_tpu_torch.ops.taylor import choose_taylor_terms as got

    rng = np.random.default_rng(3)
    for n, st in [(2, True), (3, False), (12, False)]:
        h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        H0 = h + h.conj().T
        ops = [np.diag(np.arange(n)).astype(complex)]
        args = (H0, ops, [0.5], np.identity(n), 0.05, 100, 1e-4, st, False)
        assert got(*args) == ref(*args)


def test_gates_operators_isomorphism_match():
    np.testing.assert_array_equal(qt.qft(2), q.qft(2))
    np.testing.assert_array_equal(qt.hadamard(2), q.hadamard(2))
    np.testing.assert_array_equal(qt.transmon_gate(q.SIGMA_X, 3),
                                  q.transmon_gate(q.SIGMA_X, 3))
    assert qt.concerned(2, 3) == q.concerned(2, 3)
    for name in ("SIGMA_X", "SIGMA_Y", "SIGMA_Z", "SIGMA_P", "SIGMA_M"):
        np.testing.assert_array_equal(getattr(qt, name), getattr(q, name))
    np.testing.assert_array_equal(qt.kron_all(q.SIGMA_Z, 3, np.eye(2)),
                                  q.kron_all(q.SIGMA_Z, 3, np.eye(2)))
    np.testing.assert_array_equal(qt.nn_chain_kron(q.SIGMA_Z, np.eye(2), 3, 2),
                                  q.nn_chain_kron(q.SIGMA_Z, np.eye(2), 3, 2))
    m = np.arange(9).reshape(3, 3) * (1 + 2j)
    np.testing.assert_array_equal(qt.c_to_r_mat(m), q.c_to_r_mat(m))
    np.testing.assert_array_equal(qt.r_to_c_mat(q.c_to_r_mat(m)), m)
    np.testing.assert_array_equal(qt.c_to_r_vec(m[0]), q.c_to_r_vec(m[0]))


def test_problem_tensors_are_float32_copies():
    from qoc_tpu_torch.interop import problem_tensors

    args, kwargs = _gate()
    p = TorchProblem.build(*args, **kwargs)
    tens = problem_tensors(p, "cpu")
    assert p.v_sorted_iso is None   # undressed: no dressed rotation
    assert set(tens) == {"mats", "U0_iso", "initial_vectors",
                         "target_vectors", "ops_max_amp", "u0_base",
                         "one_minus_gauss"}
    for name, x in tens.items():
        assert x.dtype == torch.float32 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), getattr(p, name))


def test_import_never_pulls_in_jax():
    code = ("import sys, qoc_tpu_torch, qoc_tpu_torch.grape, "
            "qoc_tpu_torch.ops.mega, qoc_tpu_torch.ops.tree_chain; "
            "bad = [m for m in ('jax', 'optax', 'qoc_tpu', "
            "'torch.utils.cpp_extension', 'h5py') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
