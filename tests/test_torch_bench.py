"""bench_torch.py (the counterpart of bench.py) on the CPU: each problem
builder against the problem bench.py builds inline through qoc_tpu's
front end, bit for bit; bench.py's CPU branch with ``--quick`` (one JSON
line, every key of that branch finite and positive); exit 2 without a
card; and the launches group 12 of chip_smoke.py expects of every card
window."""

import dataclasses
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

import bench_torch
import chip_smoke
import qoc_tpu as q
from qoc_tpu.models.system import ControlProblem as QProblem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(a, b, name):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), name
        for k in b:
            _assert_same(a[k], b[k], f"{name}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            _assert_same(x, y, name)
    else:
        assert a == b, name


def _make_transmon_cavity():
    """examples/jobs/make_transmon_cavity.py (it imports qoc_tpu)."""
    spec = importlib.util.spec_from_file_location(
        "make_transmon_cavity",
        os.path.join(REPO, "examples", "jobs", "make_transmon_cavity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dressed(H0, Hops, Hnames, total_time, steps, maxA):
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    psi0 = v_c[:, q.get_state_index(0, dressed_id)]
    tgt = v_c[:, q.get_state_index(1, dressed_id)]
    return QProblem.build(
        H0, Hops, Hnames, [tgt], total_time, steps, [psi0],
        state_transfer=True,
        dressed_info={"eigenvectors": v_c, "eigenvalues": np.real(w_c),
                      "dressed_id": dressed_id, "is_dressed": True},
        maxA=maxA, seed=0)


# bench.py's inline constructions, through qoc_tpu (bench.py:92-101,
# :171-187, :239-263, :290-306, :330-342, :372-386, :507-521)

def q_pi():
    return QProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, 1000,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0)


def q_leakage():
    a = q.annihilate(5)
    H0 = 2 * np.pi * (-0.2) / 2 * (a.conj().T @ a.conj().T @ a @ a)
    return QProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        q.transmon_gate(q.SIGMA_X, 5), 6.0, 100, [0, 1],
        maxA=[2.0, 2.0], seed=0)


def q_dim24():
    ql, cl = 3, 8
    aq, ac = q.annihilate(ql), q.annihilate(cl)
    Iq, Ic = np.eye(ql), np.eye(cl)
    nq = np.kron(aq.conj().T @ aq, Ic)
    nc = np.kron(Iq, ac.conj().T @ ac)
    kerr = np.kron(aq.conj().T @ aq.conj().T @ aq @ aq, Ic)
    coupling = np.kron(aq, Ic) @ np.kron(Iq, ac).conj().T
    coupling = coupling + coupling.conj().T
    H0 = (2 * np.pi * 3.9 * nq + 2 * np.pi * 4.5 * nc
          - 2 * np.pi * 0.1 * kerr + 2 * np.pi * 0.1 * coupling)
    Hops = [np.kron(aq + aq.conj().T, Ic),
            np.kron(1j * (aq - aq.conj().T), Ic)]
    return (_dressed(H0, Hops, ["qx", "qy"], 20.0, 800,
                     [2 * np.pi * 0.3] * 2),
            {"dwdt": 0.0001, "bandpass": 0.1, "band": [0.1, 10.0],
             "speed_up": 0.001})


def q_dim60():
    mtc = _make_transmon_cavity()
    H0, Hops, Hnames = mtc.build_system()
    return (_dressed(H0, Hops, Hnames, mtc.TOTAL_TIME, mtc.STEPS,
                     [mtc.MAXA] * 4),
            {"dwdt": 0.0001, "bandpass": 0.1, "band": [0.1, 10.0],
             "speed_up": 0.0001})


def q_cnot():
    CNOT = np.eye(4, dtype=complex)
    CNOT[2:, 2:] = [[0, 1], [1, 0]]
    XI = np.kron(q.SIGMA_X, np.eye(2))
    IX = np.kron(np.eye(2), q.SIGMA_X)
    ZZ = np.kron(q.SIGMA_Z, q.SIGMA_Z)
    return (QProblem.build(
        np.zeros((4, 4), dtype=complex), [XI, IX, ZZ], ["xi", "ix", "zz"],
        CNOT, 10.0, 1000, [0, 1, 2, 3], maxA=[1.0] * 3, seed=0,
        Taylor_terms=[8, 2]), {"dwdt": 0.01, "envelope": 0.1})


def q_dim200():
    Nc = 100
    a = np.kron(np.eye(2), np.diag(np.sqrt(np.arange(1, Nc)), 1))
    sm = np.kron(np.array([[0, 1], [0, 0]]), np.eye(Nc))
    H0 = (2 * np.pi * 0.1 * (a.conj().T @ a)
          + 2 * np.pi * 0.05 * (a.conj().T @ sm + a @ sm.conj().T))
    Hops = [sm + sm.conj().T, 1j * (sm - sm.conj().T), a + a.conj().T]
    psi0 = np.zeros(2 * Nc, complex)
    psi0[0] = 1
    tgt = np.zeros(2 * Nc, complex)
    tgt[Nc] = 1
    return (QProblem.build(
        H0, Hops, ["x", "y", "c"], [tgt], 4.0, 200, [psi0],
        state_transfer=True, maxA=[2 * np.pi * 0.3] * 3, seed=0),
        np.asarray(a.conj().T @ a))


def q_dim64():
    N = 64
    rng = np.random.default_rng(0)

    def herm(n):
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (A + A.conj().T) / 20

    H0 = np.diag(np.arange(N)).astype(complex) * 0.1
    Hops = [herm(N) for _ in range(4)]
    U = np.eye(N, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    return QProblem.build(
        H0, Hops, ["a", "b", "c", "d"], U, 10.0, 200, [0, 1, 2, 3],
        maxA=[1.0] * 4, seed=0, Taylor_terms=[8, 2])


BUILDERS = [
    ("pi_pulse", bench_torch._problem, q_pi),
    ("leakage", bench_torch._leakage_problem, q_leakage),
    ("cavity_dim24", bench_torch._cavity_dim24_problem, q_dim24),
    ("cavity_dim60", bench_torch._cavity_dim60_problem, q_dim60),
    ("cnot", bench_torch._cnot_problem, q_cnot),
    ("dim200", bench_torch._dim200_problem, q_dim200),
    ("dim64", bench_torch._dim64_problem, q_dim64),
]


@pytest.mark.parametrize("name,port,ref", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
def test_builder_matches_bench_py(name, port, ref):
    """Every field of the ControlProblem, and the reg_coeffs or the
    operator the builder returns beside it, equal to qoc_tpu's bit for
    bit."""
    got, want = port(), ref()
    if isinstance(want, tuple):
        (got, got_extra), (want, want_extra) = got, want
        _assert_same(got_extra, want_extra, name)
    for f in dataclasses.fields(QProblem):
        _assert_same(getattr(got, f.name), getattr(want, f.name),
                     f"{name}.{f.name}")


def test_dim60_system_is_make_transmon_cavity():
    """bench_torch.py builds config 4 from the port's generator
    (examples/jobs/torch_make_transmon_cavity.py, its one copy), whose
    system and constants are examples/jobs/make_transmon_cavity.py's."""
    import torch_make_transmon_cavity as tmtc

    mtc = _make_transmon_cavity()
    assert bench_torch.build_system is tmtc.build_system
    for k in ("QLEV", "CLEV", "DELTA_C", "ALPHA", "G", "MAXA", "TOTAL_TIME",
              "STEPS"):
        assert getattr(tmtc, k) == getattr(mtc, k), k
    for k in ("MAXA", "TOTAL_TIME", "STEPS"):
        assert getattr(bench_torch, k) == getattr(mtc, k), k
    _assert_same(bench_torch.build_system(), mtc.build_system(), "system")


# bench.py's CPU branch fills these keys (bench.py:705-757, 759-789);
# the accelerator-only ones stay null
CPU_KEYS = ("value", "vs_baseline", "cpu_iters_per_sec",
            "xla_tree_iters_per_sec", "batched_1024seed_iters_per_sec",
            "dim64_unitary_iters_per_sec", "dim64_vs_cpu",
            "cavity_costs_dim24_iters_per_sec",
            "leakage_transmon_iters_per_sec",
            "leakage_transmon_xla_iters_per_sec", "wall_clock_to_1e-4_s",
            "final_loss", "iterations_to_target")
CARD_ONLY = ("dim200_cavity_128seed_iters_per_sec",
             "dim200_cavity_64seed_iters_per_sec",
             "dim200_speedup_64seed_iters_per_sec",
             "dim200_single_iters_per_sec",
             "dim200_4096seed_grid_seediters_per_sec",
             "cavity_costs_dim60_iters_per_sec",
             "cnot_reg_batched_seediters_per_sec",
             "batched_1024seed_chain_iters_per_sec")


def test_cpu_branch_quick(capsys):
    """``main(["--device", "cpu", "--quick"])``: one JSON line, every key
    of bench.py's CPU branch finite and positive, the card-only keys null,
    each window's runs positive and no kernel launched; the wall clock
    reaches 1e-4."""
    assert bench_torch.main(["--device", "cpu", "--quick"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    for k in CPU_KEYS:
        assert math.isfinite(rep[k]) and rep[k] > 0, k
    for k in CARD_ONLY:
        assert rep[k] is None, k
    assert rep["quick"] is True and rep["device"] == "cpu"
    assert rep["final_loss"] < 1e-4
    assert set(rep["windows"]) == set(bench_torch.CPU_WINDOWS)
    for name, w in rep["windows"].items():
        assert len(w["runs"]) == bench_torch.REPEATS, name
        assert all(r > 0 for r in w["runs"]), name
        assert w["launches"] == [{}] * bench_torch.REPEATS, name


def test_needs_the_card_without_device(capsys, monkeypatch):
    """No card and no ``--device cpu``: exit 2, nothing on stdout."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_group12_expects_every_card_window():
    """chip_smoke's group 12 holds every card window but the wall clock
    to a launch count, and each count to a kernel the port has."""
    from qoc_tpu_torch.ops import _cuda

    want = chip_smoke._expected_launches(bench_torch.QUICK_ITERS)
    assert set(want) == set(bench_torch.CARD_WINDOWS) - {"wall_clock"}
    assert all(set(w) <= set(_cuda.LAUNCHES) for w in want.values())
