"""Kernel 3 (the fused Adam segment) spreads one problem over a
thread-block cluster: what of that design the CPU can check.  The launch
geometry (``_cuda.mega_geometry``, the mirror of mega.cuh's rule) at every
shape ``chip_smoke.py`` runs and over the range the gate admits; the
clock64 split with kernel 3's phases; the device scratch (no buffer of
order M^2 Tp, checked on the ``meta`` device with the launch replaced by a
recorder); and the kernel's chain association (segment walks, a tree per
block, the cluster's products, the states and their cotangents pulled
down the tree) as a plain torch model held against qoc_tpu's
Hillis-Steele scan (``scan_forward_vals`` / ``scan_backward_vals``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from qoc_tpu.ops.pallas_tree import scan_backward_vals, scan_forward_vals
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.ops.expm import taylor_expm, weighted_hamiltonians
from qoc_tpu_torch.ops.mega import (mega_supported, segment_costs,
                                    segment_inputs, segment_lanes)
from qoc_tpu_torch.ops.tree_chain import tree_chain_supported

from test_torch_chain_teams import empty_meta, recorded  # noqa: F401

torch.set_num_threads(1)


def _smoke_problems():
    """chip_smoke.py's kernel-3 problems (phases 3, 3b and 4)."""
    probs = chip_smoke._problems()
    leak = probs["transmon_leakage"]
    yield "pi_pulse", chip_smoke._build_problem(probs["pi_pulse"]), None
    yield "cnot", chip_smoke._build_problem(probs["cnot"]), None
    yield ("transmon_leakage", chip_smoke._build_problem(leak),
           leak["kwargs"]["reg_coeffs"])
    yield ("all_seven_unitary", chip_smoke._build_problem(
        chip_smoke._ladder(False)), chip_smoke.ALL_SEVEN)
    yield ("state_speed_up_bandpass_forbidden", chip_smoke._build_problem(
        chip_smoke._ladder(True)), chip_smoke.SPD_BP_FORB)


def _shape(p, rc):
    """(M, Tp, K, V, order, scaling) and the instance's flags."""
    mats, psi0p, _, _, _, order, s = segment_inputs(p, "cpu")
    costs = segment_costs(p, rc, "cpu")
    return ((mats.shape[1], segment_lanes(p, rc), mats.shape[0],
             psi0p.shape[1], order, s),
            dict(costs=costs is not None,
                 traj=bool(costs is not None and costs.traj)))


def _check_geometry(g, M, Tp):
    assert g.blocks in (1, 2, 4, 8, 16)
    assert g.team == _cuda.team_lanes(M)
    assert g.lanes_per_block * g.blocks == Tp
    assert g.threads == g.teams * g.team and g.threads % 32 == 0
    assert 32 <= g.threads <= _cuda.MEGA_THREADS and g.teams <= 64
    assert g.threads & (g.threads - 1) == 0       # block_sum halves it
    # every lane in exactly one team's segment (lanes past TB: identities)
    assert g.teams * g.segment >= g.lanes_per_block
    assert g.segment == 1 or g.teams * g.segment == g.lanes_per_block
    assert 0 < g.smem <= _cuda.MEGA_SMEM_MAX


@pytest.mark.parametrize("name", [n for n, _, _ in _smoke_problems()])
def test_geometry_at_the_smoke_problems(name):
    p, rc = next((p, rc) for n, p, rc in _smoke_problems() if n == name)
    assert mega_supported(p, rc)
    shape, flags = _shape(p, rc)
    M, Tp = shape[:2]
    g = _cuda.mega_geometry(*shape, **flags)
    _check_geometry(g, M, Tp)
    # T = 1000 on 1024 lanes: a cluster of 8 blocks of 128 lanes, at most
    # 64 teams of 512 threads (256 in the costs instance)
    assert Tp == 1024 and g.blocks == 8 and g.lanes_per_block == 128
    cap = 256 if flags["costs"] else 512
    assert g.teams == min(64, cap // g.team)
    assert g.segment == 128 // g.teams


def test_geometry_of_the_cnot_and_config_3():
    """The two shapes the redesign is for, worked out by hand."""
    # the CNOT: M = 8, K = 6, V = 4, order 3; 64 teams of 8 lanes
    g = _cuda.mega_geometry(8, 1024, 6, 4, 3, 0)
    assert g[:6] == (8, 512, 8, 64, 128, 2)
    # config 3: M = 10, K = 3, V = 2, order 4, the costs instance in
    # trajectory mode; 16 teams of 16 lanes, 8 lanes a segment
    g = _cuda.mega_geometry(10, 1024, 3, 2, 4, 0, costs=True, traj=True)
    assert g[:6] == (8, 256, 16, 16, 128, 8)
    MP, nseg, mat, vec = 12, 16, 120, 24
    TS = 288 + vec        # (reps + nterms + 2 + L) MP floats, then nu
    floats = (332 + 8 + 4 + (2 * nseg - 1) * (mat + vec) + 129 * vec
              + (nseg + 1) * vec + 8 * (mat + vec) + 2 * 3 * MP + 3 * vec
              + nseg * TS + 256 + 8 + 2 * 128 + 129 * vec)
    assert g.smem == 4 * floats


@pytest.mark.parametrize("M", _cuda.SUPPORTED_M)
@pytest.mark.parametrize("instance", ["fidelity", "costs", "trajectory"])
def test_geometry_fits_what_the_gate_admits(M, instance):
    """At the most lanes the gate admits for M (segment_lanes doubles the
    tree's bound for the difference costs), with as many concerned vectors
    as the system has levels (every state of a gate), realistic generator
    counts and Taylor terms fit a block's shared memory over at most 16
    blocks; so do a few lanes."""
    Tp = 2
    while tree_chain_supported(M, 2 * Tp):
        Tp *= 2
    Tp *= 2                                      # segment_lanes' doubling
    flags = dict(costs=instance != "fidelity", traj=instance == "trajectory")
    V = min(M // 2, _cuda.MAX_V_TRAJ if flags["traj"] else _cuda.MAX_V)
    for K, order, s in ((3, 20, 0), (8, 12, 2), (16, 6, 4)):
        g = _cuda.mega_geometry(M, Tp, K, V, order, s, **flags)
        _check_geometry(g, M, Tp)
        assert g.threads <= (256 if flags["costs"] else 512)
    for Tp_small in (2, 4, 32, 64):
        _check_geometry(_cuda.mega_geometry(M, Tp_small, 3, 1, 3, 0, **flags),
                        M, Tp_small)


def test_geometry_refuses_what_does_not_fit():
    """The lanes' states stay in shared memory, so many vectors at the most
    lanes do not fit (16 vectors of a 2-level system over 65536 lanes; a
    generator copy of 48 KB with 16 vectors at M = 12): blocks is 0 and
    the launch raises before it reaches the card."""
    assert _cuda.mega_geometry(2, 65536, 3, 16, 3, 0).blocks == 0
    assert _cuda.mega_geometry(12, 2048, 85, 16, 20, 0).blocks == 0
    traj = dict(costs=True, traj=True)
    assert _cuda.mega_geometry(2, 65536, 3, 1, 3, 0, **traj).blocks == 16
    # 40 generators, scaling 5 and 8 vectors at M = 12: 16 blocks of half
    # the threads (a quarter of the fidelity instance's cap)
    g = _cuda.mega_geometry(12, 2048, 40, 8, 12, 5, **traj)
    assert g.blocks == 16 and g.threads == 128
    g = _cuda.mega_geometry(12, 2048, 40, 8, 12, 5)
    assert g.blocks == 16 and g.threads == 256


def test_clock_split_of_kernel_3():
    P = len(_cuda.MEGA_CLOCK_PHASES)
    assert _cuda.MEGA_CLOCK_PHASES == (
        "taylor_forward", "penalties", "chain_forward", "loss",
        "trajectory", "chain_reverse", "taylor_reverse",
        "grad2_convergence", "adam")
    clocks = torch.zeros((8, P), dtype=torch.int64)
    clocks[:, 0] = 100          # every block the same Taylor forward
    clocks[0, 5] = 400
    clocks[7, 8] = 400
    split = _cuda.clock_split(clocks, _cuda.MEGA_CLOCK_PHASES)
    assert list(split) == list(_cuda.MEGA_CLOCK_PHASES)
    assert split["taylor_forward"] == pytest.approx(0.5)
    assert split["chain_reverse"] == pytest.approx(0.25)
    assert split["adam"] == pytest.approx(0.25)
    assert sum(split.values()) == pytest.approx(1.0)


# ---- the device scratch, on the meta device -------------------------------

def _meta(*shape):
    return empty_meta(shape)


def _segment_ops(K, M, V, Tp):
    return (_meta(K, M, M), _meta(M, V), _meta(M, V), _meta(K - 1),
            _meta(M), _meta(K - 1, Tp), _meta(K - 1, Tp), _meta(K - 1, Tp),
            _meta(3))


_STATICS = dict(N=4, T=1000, order=3, scaling=0, n_iters=100,
                unitary_mode=True, b1=0.9, b2=0.999, eps=1e-8,
                rate_factor=0.999, conv_target=1e-8, min_grad=1e-25,
                max_iterations=5000.0)


def test_segment_scratch_has_no_residuals(recorded):
    """The CNOT's segment: scratch sw and g [Kc, Tp], the metrics, and no
    buffer of Taylor powers, tree levels or cotangents (M^2 Tp each in the
    parent); the launch takes no pointer for them."""
    rec, allocs = recorded
    K, M, V, Tp = 6, 8, 4, 1024
    dev = torch.device("meta")
    scratch = _cuda.mega_scratch(K, Tp, dev)
    assert [tuple(x.shape) for x in scratch] == [(K - 1, Tp)] * 2
    assert all(len(a) == 2 and a[0] * a[1] < M * M * Tp for a in allocs)
    ops = _segment_ops(K, M, V, Tp)
    allocs.clear()
    _cuda.mega_segment(*ops, scratch=scratch, **_STATICS)
    assert allocs == [(8,)]                        # met only
    (name, args), = rec.calls
    assert name == "qoc_mega_segment"
    assert len(args) == 11 + 12 + 11 + 1           # clocks, no residuals
    assert args[22] is None                        # clocks not asked for
    geo = _cuda.mega_geometry(M, Tp, K, V, 3, 0)
    with pytest.raises(ValueError, match="clocks"):
        _cuda.mega_segment(
            *_segment_ops(K, M, V, Tp), scratch=scratch,
            clocks=torch.zeros((geo.blocks - 1, 9), dtype=torch.int64,
                               device=dev), **_STATICS)


def test_costs_scratch_is_sized_by_the_cluster(recorded):
    """Config 3's shape with 495 bandpass bins: sw and g, and the bandpass
    spectra [2, G, Kc, F, 2] (each block's partial sums, then its finished
    copy); nothing of order M^2 Tp."""
    _, allocs = recorded
    K, M, V, Tp, F = 3, 10, 2, 1024, 495
    scratch = _cuda.mega_costs_scratch(K, M, Tp, V, 4, 0, F, True,
                                       torch.device("meta"))
    G = _cuda.mega_geometry(M, Tp, K, V, 4, 0, costs=True, traj=True).blocks
    assert G == 8
    assert [tuple(x.shape) for x in scratch] == [
        (K - 1, Tp), (K - 1, Tp), (2, G, K - 1, F, 2)]
    assert sum(np.prod(a) for a in allocs) < M * M * Tp


def test_a_problem_that_does_not_fit_raises(recorded):
    rec, _ = recorded
    K, M, V, Tp = 85, 12, 16, 2048
    scratch = _cuda.mega_scratch(K, Tp, torch.device("meta"))
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.mega_segment(*_segment_ops(K, M, V, Tp), scratch=scratch,
                           **dict(_STATICS, order=20))
    assert rec.calls == []


# ---- the chain association, against qoc_tpu's scan -------------------------

def _seg_tree(Q):
    """Levels of the pairwise tree over a block's segment products [n, M,
    M] (later on the left): level l + 1 = level l [1::2] @ level l [0::2]."""
    levels = [Q]
    while levels[-1].shape[0] > 1:
        q = levels[-1]
        levels.append(q[1::2] @ q[0::2])
    return levels


def segmented_chain(P, psi0, D, fbar, G, S):
    """Kernel 3's association on matrices, for one problem: P [Tp, M, M]
    the step propagators, psi0 [M, V], D [Tp + 1, M, V] the costs' direct
    cotangents of the states x_t, fbar the final state's.  Returns (x
    [Tp + 1, M, V], Pbar [Tp, M, M]) with x_{t+1} = P_t x_t and Pbar_t =
    (D_{t+1} + nu_{t+1}) x_t^T, nu the cotangent from later steps, each
    formed as the kernel forms it: segment products and R sums walked per
    segment, a tree per block, the cluster's products in order, states and
    cotangents pulled down the tree, then walked through each segment."""
    Tp, M, _ = P.shape
    TB = Tp // G
    nseg = TB // S
    eye = torch.eye(M, dtype=P.dtype)

    def seg(b, j):
        return range(b * TB + j * S, b * TB + (j + 1) * S)

    trees, Rtrees = [], []
    for b in range(G):
        Q, R = [], []
        for j in range(nseg):
            q = eye
            for t in seg(b, j):
                q = P[t] @ q
            Q.append(q)
            r = torch.zeros_like(psi0)     # the segment's D's at its start
            for t in reversed(seg(b, j)):
                r = P[t].T @ (D[t + 1] + r)
            R.append(r)
        levels = _seg_tree(torch.stack(Q))
        rl = [torch.stack(R)]
        for lv in levels[:-1]:
            r = rl[-1]
            rl.append(r[0::2] + lv[0::2].transpose(-1, -2) @ r[1::2])
        trees.append(levels)
        Rtrees.append(rl)
    C = [t[-1][0] for t in trees]
    Rb = [r[-1][0] for r in Rtrees]
    # the cluster: states at the block starts, cotangents at the block ends
    xs = [psi0]
    for b in range(G):
        xs.append(C[b] @ xs[-1])
    nus = [None] * G
    z = fbar
    for b in range(G - 1, -1, -1):
        nus[b] = z
        z = Rb[b] + C[b].T @ z
    x = torch.zeros((Tp + 1, M, psi0.shape[1]), dtype=P.dtype)
    Pbar = torch.zeros_like(P)
    for b in range(G):
        levels, rl = trees[b], Rtrees[b]
        start = [xs[b]]                     # states at the segment starts
        end = [nus[b]]                      # cotangents at the segment ends
        for lv, r in zip(reversed(levels[:-1]), reversed(rl[:-1])):
            start = [s for a, i in zip(start, range(len(start)))
                     for s in (a, lv[2 * i] @ a)]
            end = [e for a, i in zip(end, range(len(end)))
                   for e in (r[2 * i + 1] + lv[2 * i + 1].T @ a, a)]
        for j in range(nseg):
            ts = list(seg(b, j))
            x[ts[0]] = start[j]
            for t in ts[:-1]:
                x[t + 1] = P[t] @ x[t]
            nu = end[j]
            for t in reversed(ts):
                mu = D[t + 1] + nu
                Pbar[t] = mu @ x[t].T
                nu = P[t].T @ mu
    x[Tp] = xs[G]
    return x, Pbar


def _chain_case(seed, M=4, K=3, Tp=32, V=2, order=3, scaling=1):
    rng = np.random.default_rng(seed)
    n = M // 2
    mats = []
    for _ in range(K):
        h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        h = -1j * 0.3 * (h + h.conj().T) / 2
        mats.append(np.block([[h.real, -h.imag], [h.imag, h.real]]))
    mats = np.stack(mats).astype(np.float32)
    w = rng.standard_normal((K, Tp)).astype(np.float32)
    psi0 = rng.standard_normal((M, V)).astype(np.float32)
    return mats, w, psi0, order, scaling


@pytest.mark.parametrize("G,S", [(1, 1), (2, 2), (4, 1), (4, 2), (2, 8)])
@pytest.mark.parametrize("costs", ["trajectory", "final"])
def test_association_matches_the_hillis_steele_scan(G, S, costs):
    """The states X[t] psi0 and the weight cotangents of a dense trajectory
    cotangent (or of the final state's alone) by the kernel's association
    agree with qoc_tpu's scan at the float32 floor."""
    mats, w, psi0, order, s = _chain_case(G * 10 + S)
    K, M, _ = mats.shape
    Tp, V = w.shape[1], psi0.shape[1]
    rng = np.random.default_rng(7)
    trajbar = rng.standard_normal((Tp, M, V)).astype(np.float32)
    if costs == "final":
        trajbar[:-1] = 0.0

    # qoc_tpu: prefix products on [M, M, Tp], Xbar[t] = trajbar[t] psi0^T
    jm = jnp.asarray(mats)
    X, an, sq, levels = scan_forward_vals(M, order, s, jm, jnp.asarray(w))
    ref_traj = np.einsum("ijt,jv->tiv", np.asarray(X), psi0)
    Xbar = jnp.asarray(np.einsum("tiv,jv->ijt", trajbar, psi0))
    ref_wbar = np.stack([np.asarray(r) for r in scan_backward_vals(
        M, order, s, jm, an, sq, levels, Xbar)])

    # the port: the plain Taylor steps, chained by the kernel's association
    wt = torch.from_numpy(w).requires_grad_(True)
    P = taylor_expm(weighted_hamiltonians(torch.from_numpy(mats), wt),
                    order, s)
    D = torch.zeros((Tp + 1, M, V))
    fbar = torch.zeros((M, V))
    if costs == "final":
        fbar = torch.from_numpy(trajbar[-1])
    else:
        D[1:] = torch.from_numpy(trajbar)
    x, Pbar = segmented_chain(P.detach(), torch.from_numpy(psi0), D, fbar,
                              G, S)
    (wbar,) = torch.autograd.grad(P, wt, Pbar)
    traj = x[1:].numpy()
    assert np.abs(traj - ref_traj).max() <= 2e-6 * np.abs(ref_traj).max()
    np.testing.assert_allclose(x[-1].numpy(), ref_traj[-1], atol=2e-6)
    err = np.abs(wbar.numpy() - ref_wbar).max() / np.abs(ref_wbar).max()
    assert err <= 1e-5, err


def test_association_model_is_not_trivially_the_scan():
    """The model's sums really take another order: at G = 4, S = 2 its
    states differ from a serial chain's in the last bits somewhere, while
    both sit at the float32 floor of a float64 chain."""
    mats, w, psi0, order, s = _chain_case(3)
    P = taylor_expm(weighted_hamiltonians(torch.from_numpy(mats),
                                          torch.from_numpy(w)), order, s)
    Tp, M, _ = P.shape
    p0 = torch.from_numpy(psi0)
    zeros = torch.zeros((Tp + 1, M, psi0.shape[1]))
    x, _ = segmented_chain(P, p0, zeros, torch.zeros_like(p0), 4, 2)
    serial = [p0]
    for t in range(Tp):
        serial.append(P[t] @ serial[-1])
    serial = torch.stack(serial)
    s64 = [p0.double()]
    for t in range(Tp):
        s64.append(P[t].double() @ s64[-1])
    s64 = torch.stack(s64)
    assert not torch.equal(x, serial)
    assert (x.double() - s64).abs().max() <= 2e-6
    assert (serial.double() - s64).abs().max() <= 2e-6
