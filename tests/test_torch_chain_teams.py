"""Kernels 5 and 6 give each column a team of lanes: what of that design
the CPU can check.  The launch geometry (``_cuda.batch_geometry``) and
the shared memory of a step's replayed powers, which ``chain_fits`` now
weighs; the admission of every problem the tests and ``chip_smoke.py``
run (the gate admits each as it did when it checked only M and K); the
clock64 split helper; and the scratch: no device buffer of replayed
powers is allocated for either kernel (checked on the ``meta`` device
with the launch replaced by a recorder)."""

import numpy as np
import pytest
import torch

import chip_smoke
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.parallel.chain_batch import pallas_batch_supported
from qoc_tpu_torch.parallel.cols_batch import chain_order
from qoc_tpu_torch.parallel.mega_batch import batched_mega_supported

from test_torch_mega_batch import CASES as MEGA_CASES
from test_torch_state_chain import CASES as CHAIN_CASES


@pytest.mark.parametrize("M", _cuda.SUPPORTED_M)
def test_team_is_the_least_power_of_two(M):
    L = _cuda.team_lanes(M)
    assert L & (L - 1) == 0 and M <= L < 2 * M and 32 % L == 0


@pytest.mark.parametrize("M", _cuda.SUPPORTED_M)
@pytest.mark.parametrize("seeds", [130, 13])
def test_no_seed_group_straddles_a_block(M, seeds):
    """For V = 1..8: a block holds whole seed groups (V * L lanes), is one
    warp where a group fits one, and the grid covers every seed with no
    block left empty."""
    for V in range(1, _cuda.MAX_V_BATCH + 1):
        g = _cuda.batch_geometry(M, V, seeds * V)
        G = V * g.lanes
        assert g.lanes == _cuda.team_lanes(M)
        assert g.threads % 32 == 0 and 0 <= g.threads - g.groups * G < 32
        assert g.threads == 32 or g.groups == 1
        assert g.threads <= 32 * 4       # __launch_bounds__ of kernel 6
        assert (g.blocks - 1) * g.groups < seeds <= g.blocks * g.groups
        for s in (0, seeds - 1):         # its lanes in one block
            block, first = divmod(s, g.groups)
            assert (first + 1) * G <= g.threads


@pytest.mark.parametrize("M", _cuda.SUPPORTED_M)
def test_shared_memory_stays_under_the_limit(M):
    """At the most generators and the tests' largest order and scaling
    (12, 2), every V fits the shared memory a block may take."""
    for V in range(1, _cuda.MAX_V_BATCH + 1):
        for order, s in ((12, 2), (12, 0), (3, 0)):
            b5 = _cuda.state_chain_backward_smem(_cuda.MAX_K, M, order, s)
            b6 = _cuda.mega_batch_smem(_cuda.MAX_K, M, V, order, s)
            assert max(b5, b6) <= _cuda.CHAIN_SMEM_MAX
            assert _cuda.chain_fits(_cuda.MAX_K, M, order, s, V)
    # the powers are what grows: an absurd order is refused by rule
    assert not _cuda.chain_fits(3, M, 4000, 6, 8)


def test_shared_memory_counts_generators_coefficients_and_powers():
    K, M, V, order, s = 6, 8, 4, 4, 0      # the CNOT: 32 lanes, one warp
    g = _cuda.batch_geometry(M, V, 64 * V)
    assert g == (8, 1, 32, 64)
    KG = _cuda.team_slots(K)
    assert KG == 8 and [_cuda.team_slots(k) for k in (1, 4, 5, 9, 16)] == [
        4, 4, 8, 16, 16]
    floats = KG * M * (M + 1) + order + 32 // 8 + (order << s) * 32
    assert _cuda.mega_batch_smem(K, M, V, order, s) == 4 * floats
    assert _cuda.state_chain_backward_smem(K, M, order, s) == 4 * (
        KG * M * (M + 1) + order + (order << s) * _cuda.TEAM_THREADS)
    # three vectors of 8 lanes: one group of 24 lanes in a warp of 32
    assert _cuda.batch_geometry(6, 3, 30) == (8, 1, 32, 10)
    # five vectors of 16 lanes: one group of 80 lanes in three warps
    assert _cuda.batch_geometry(12, 5, 10) == (16, 1, 96, 2)


def _mega_case_problems():
    for name, (make, rc, *_rest) in MEGA_CASES.items():
        args, kwargs = make()
        yield name, TorchProblem.build(*args, **kwargs), rc


def _smoke_problems():
    probs = chip_smoke._problems()
    yield "pi_pulse", chip_smoke._pi05(), None
    yield "cnot", chip_smoke._build_problem(probs["cnot"]), None
    leak = probs["transmon_leakage"]
    yield ("transmon_leakage", chip_smoke._build_problem(leak),
           leak["kwargs"]["reg_coeffs"])
    yield ("ladder_all_seven", chip_smoke._build_problem(
        chip_smoke._ladder(False)), chip_smoke.ALL_SEVEN)
    yield ("ladder_state", chip_smoke._build_problem(
        chip_smoke._ladder(True)), chip_smoke.SPD_BP_FORB)


@pytest.mark.parametrize("source", ["tests", "chip_smoke"])
def test_gate_admits_the_problems_it_admitted(source):
    """Every problem of tests/test_torch_mega_batch.py::CASES and of
    chip_smoke.py's batched phases is admitted, as it was when the gate
    checked M, K and V alone; the state chain's gate too where the
    penalties allow it."""
    problems = (_mega_case_problems() if source == "tests"
                else _smoke_problems())
    for name, p, rc in problems:
        K, M = p.ops_len + 1, 2 * p.state_num
        V = p.initial_vectors.shape[1]
        order, s = chain_order(p)
        assert M in _cuda.SUPPORTED_M and K <= _cuda.MAX_K and V <= 8
        assert _cuda.chain_fits(K, M, order, s, V), name
        assert batched_mega_supported(p, rc), name
        assert pallas_batch_supported(p, None), name


@pytest.mark.parametrize("K,M,C,T,order,scaling", CHAIN_CASES)
def test_state_chain_cases_fit(K, M, C, T, order, scaling):
    assert _cuda.chain_fits(K, M, order, scaling)


def test_clock_split():
    """Each phase's share of the cycles summed over blocks; zeros stay
    zeros."""
    P = len(_cuda.CLOCK_PHASES)
    assert P == 7 and _cuda.CLOCK_PHASES[1] == "forward"
    clocks = torch.zeros((3, P), dtype=torch.int64)
    clocks[0, 1] = 600
    clocks[1, 1] = 200
    clocks[1, 3] = 150
    clocks[2, 6] = 50
    split = _cuda.clock_split(clocks)
    assert list(split) == list(_cuda.CLOCK_PHASES)
    assert split["forward"] == pytest.approx(0.8)
    assert split["reverse"] == pytest.approx(0.15)
    assert split["adam"] == pytest.approx(0.05)
    assert split["sin"] == 0.0 and sum(split.values()) == pytest.approx(1.0)
    assert set(_cuda.clock_split(torch.zeros((2, P), dtype=torch.int64))
               .values()) == {0.0}


def empty_meta(shape):
    return torch.zeros(shape, device="meta")


class _Recorder:
    """Stands in for the kernel library: records each launch's operands."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def recorded(monkeypatch):
    """Launches on ``meta`` tensors reach the recorder; every torch.empty
    of the wrappers is logged by shape."""
    rec = _Recorder()
    allocs = []
    empty = torch.empty

    def logged_empty(*shape, **kw):
        out = empty(*shape, **kw)
        allocs.append(tuple(out.shape))
        return out

    monkeypatch.setattr(_cuda, "_library", lambda: rec)
    monkeypatch.setattr(_cuda, "_check", lambda *ts: ts[0].device)
    monkeypatch.setattr(_cuda, "_stream", lambda dev: 0)
    monkeypatch.setattr(torch, "empty", logged_empty)
    return rec, allocs


def test_state_chain_backward_allocates_no_powers(recorded):
    rec, allocs = recorded
    K, M, C, T, order, s = 3, 4, 7, 8, 3, 2
    mats = empty_meta((K, M, M))
    w = empty_meta((T, K, C))
    traj = empty_meta((T + 1, M, C))
    gbar = empty_meta((M, C))
    allocs.clear()
    _cuda.state_chain_backward(mats, w, traj, gbar, order, s)
    assert allocs == [(T, K, C), (M, C)]          # wbar, psibar
    (name, args), = rec.calls
    assert name == "qoc_state_chain_backward"
    assert len(args) == 4 + 6 + 2 + 1              # no scratch pointer
    assert args[4:10] == (K, M, T, C, order, s)


def test_mega_batch_scratch_holds_no_powers(recorded):
    rec, allocs = recorded
    M, T, Kc, V, S = 8, 6, 4, 4, 3
    C = S * V
    dev = torch.device("meta")
    scratch = _cuda.mega_batch_scratch(M, T, Kc, C, V, dev)
    assert [tuple(x.shape) for x in scratch] == [
        (T + 1, C, M), (S, T, Kc), (C, T, Kc), (S, T, Kc)]
    K = 1 + Kc
    ops = [empty_meta((K, M, M)), empty_meta((Kc,)), empty_meta((M, V)),
           empty_meta((M, V)), empty_meta((1, C)), empty_meta((T, Kc, C)),
           empty_meta((T, Kc, C)), empty_meta((T, Kc, C)),
           empty_meta((1, C)), empty_meta((1, C))]
    adam = {f: 0.5 for f, _ in _cuda.BatchAdam._fields_}
    allocs.clear()
    _cuda.mega_batch_segment(*ops, order=4, scaling=0, n_iters=2, adam=adam,
                             scratch=scratch)
    assert allocs == [(3, C)]                      # stats only
    (name, args), = rec.calls
    assert name == "qoc_mega_batch_segment"
    assert len(args) == 1 + 9 + 15 + 1 + 1         # clocks, no powers
    assert args[24] is None                        # clocks not asked for
    with pytest.raises(ValueError, match="clocks"):
        _cuda.mega_batch_segment(
            *ops, order=4, scaling=0, n_iters=2, adam=adam, scratch=scratch,
            clocks=torch.zeros((S - 1, 7), dtype=torch.int64, device=dev))


# ---- kernel 4 (the state chain's forward) in the team form -----------------

@pytest.mark.parametrize("M", _cuda.SUPPORTED_M)
@pytest.mark.parametrize("C", [1, 13, 130, 256, 1024])
def test_state_chain_forward_geometry(M, C):
    """Kernels 4 and 5 launch alike: a team of team_lanes(M) lanes per
    column, one-warp blocks of 32 / L columns, every column in a block and
    no block empty."""
    g = _cuda.chain_geometry(M, C)
    L = _cuda.team_lanes(M)
    assert g == (L, 32, -(-C * L // 32))
    cols = 32 // L
    assert (g.blocks - 1) * cols < C <= g.blocks * cols


def test_state_chain_forward_smem_is_weighed():
    """Kernel 4's shared memory (the generators in team_slots(K) slots and
    the Taylor coefficients) enters chain_fits beside kernels 5 and 6."""
    K, M, order = 6, 8, 4
    assert _cuda.state_chain_forward_smem(K, M, order) == 4 * (
        8 * M * (M + 1) + order)
    for K, M, order, s in ((3, 4, 3, 0), (16, 12, 12, 2), (6, 8, 4, 1)):
        need = max(_cuda.state_chain_forward_smem(K, M, order),
                   _cuda.state_chain_backward_smem(K, M, order, s),
                   _cuda.mega_batch_smem(K, M, 1, order, s))
        assert _cuda.chain_fits(K, M, order, s) == (
            need <= _cuda.CHAIN_SMEM_MAX)
        assert _cuda.state_chain_forward_smem(K, M, order) <= need


def test_state_chain_forward_launch(recorded):
    """The forward allocates its outputs only and passes the problem's
    order and scaling (its smem is sized from them)."""
    rec, allocs = recorded
    K, M, C, T, order, s = 3, 10, 5, 7, 4, 1
    mats = empty_meta((K, M, M))
    w = empty_meta((T, K, C))
    psi0 = empty_meta((M, C))
    allocs.clear()
    _cuda.state_chain_forward(mats, w, psi0, order, s)
    assert allocs == [(M, C), (T + 1, M, C)]      # out, trajectory
    (name, args), = rec.calls
    assert name == "qoc_state_chain_forward"
    assert args[3:9] == (K, M, T, C, order, s)
    with pytest.raises(ValueError, match="bounds"):
        _cuda.state_chain_forward(empty_meta((17, M, M)),
                                  empty_meta((T, 17, C)), psi0, order, s)
