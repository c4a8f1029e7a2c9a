"""Kernels 1-2 (the tree chain) spread one problem over a cluster of blocks
in teams of lanes: what of that design the CPU can check.  The launch
geometry (``_cuda.tree_geometry``, the mirror of tree_chain.cuh's rule)
at the shapes ``chip_smoke.py`` runs and at every shape the routing
admits; the residuals (segment and block products only, nothing of order
M^2 Tp per Taylor power, squaring or tree level), checked on the ``meta``
device with the launch replaced by a recorder; the clock64 phases; and
the kernels' association (segment products by Horner and squarings, a
tree per block, the cluster's products, prefixes and nu down the tree,
the squarings reversed and Abar by Horner on the block-triangular form)
as a plain torch model held against qoc_tpu's Pallas tree kernel,
interpreted on the CPU as ``tests/test_torch_tree.py`` runs it.  Inputs
are made with numpy from a seed and handed to both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from qoc_tpu.ops.pallas_tree import fused_tree_chain as j_tree
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.ops.tree_chain import (tree_chain_reference,
                                          tree_chain_supported)

from test_torch_chain_teams import empty_meta, recorded  # noqa: F401

torch.set_num_threads(1)

# the most lanes qoc_tpu's rule admits for each M (residuals under 10 MB)
MAX_TP = {2: 32768, 4: 8192, 6: 4096, 8: 2048, 10: 1024, 12: 1024}


def _check_geometry(g, M, Tp):
    assert 1 <= g.blocks <= _cuda.TREE_MAX_BLOCKS
    assert g.blocks & (g.blocks - 1) == 0
    assert g.team == _cuda.team_lanes(M)
    assert g.lanes_per_block * g.blocks == Tp
    assert g.threads == g.teams * g.team and g.threads % 32 == 0
    assert g.threads & (g.threads - 1) == 0      # a full tree of teams
    assert 32 <= g.threads <= _cuda.TREE_THREADS and g.teams <= 64
    # every lane in exactly one team's segment (segments past TB: empty)
    assert g.teams * g.segment >= g.lanes_per_block
    assert g.segment == 1 or g.teams * g.segment == g.lanes_per_block
    assert 0 < g.smem_fwd <= g.smem_bwd <= _cuda.TREE_SMEM_MAX


@pytest.mark.parametrize("K,M,T,order,s", chip_smoke.TREE_SHAPES)
def test_geometry_at_the_smoke_shapes(K, M, T, order, s):
    Tp = 1 << (T - 1).bit_length()
    assert tree_chain_supported(M, T)
    g = _cuda.tree_geometry(M, Tp, K, order, s)
    _check_geometry(g, M, Tp)
    # a cluster of 8 blocks, at most 64 teams of at most 512 threads
    assert g.blocks == 8
    assert g.teams == min(64, 512 // g.team)
    assert g.segment == Tp // 8 // g.teams


def test_geometry_by_hand():
    """The pi pulse and phase 2's M = 12 shape, worked out by hand: the
    threads, the teams, each team's segment and both kernels' bytes."""
    g = _cuda.tree_geometry(4, 1024, 3, 2, 0)
    assert g[:6] == (8, 256, 4, 64, 128, 2)
    head = 60 + 4                      # mats [3][4][5], 1/k for k <= 2
    assert g.smem_fwd == 4 * (head + (127 + 8 + 64) * 16)
    assert g.smem_bwd == 4 * (head + (128 + 65) * 16 + 64 * 3 * 16)
    g = _cuda.tree_geometry(12, 1024, 3, 6, 2)
    assert g[:6] == (8, 512, 16, 32, 128, 4)
    head = 468 + 8                     # mats [3][12][13], 1/k for k <= 6
    assert g.smem_fwd == 4 * (head + (63 + 8 + 32) * 144)
    assert g.smem_bwd == 4 * (head + (128 + 33) * 144 + 32 * 3 * 144)


def test_routing_range():
    """The lanes the routing sends to the tree kernels for each M (qoc_tpu's
    rule, kept): the range the geometry must cover."""
    for M, Tp in MAX_TP.items():
        assert tree_chain_supported(M, Tp)
        assert not tree_chain_supported(M, 2 * Tp)


@pytest.mark.parametrize("M", _cuda.SUPPORTED_M)
def test_geometry_covers_what_the_routing_admits(M):
    """Some geometry launches at every lane count the routing admits for M,
    up to order 20 and 16 squarings, within the shared memory a block may
    take; scaling moves nothing (no squaring is stored)."""
    Tp = 2
    while Tp <= MAX_TP[M]:
        for K in (3, 8, 16):
            for order in (0, 1, 6, 20):
                g = _cuda.tree_geometry(M, Tp, K, order, 0)
                _check_geometry(g, M, Tp)
                assert _cuda.tree_geometry(M, Tp, K, order, 16) == g
        Tp *= 2


def test_geometry_refuses_what_does_not_fit(recorded):
    """Past the routing's range the lanes' prefixes outgrow a block's shared
    memory (M = 12 at 4096 lanes): blocks is 0 and the wrappers raise
    before anything reaches the card."""
    rec, _ = recorded
    assert _cuda.tree_geometry(12, 4096, 3, 6, 2).blocks == 0
    assert _cuda.tree_geometry(12, 2048, 3, 6, 2).blocks == 8
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.tree_forward(empty_meta((3, 12, 12)), empty_meta((3, 4096)),
                           6, 2)
    assert rec.calls == []


# ---- the residuals and the launches, on the meta device -------------------

def test_residuals_hold_no_per_step_matrices():
    """At M = 12, Tp = 1024 (order 6, two squarings) the residuals are the
    256 segment products and the 8 block products: (Tp / S + G) M^2
    floats, 152 KB, against the (order - 1 + s + log2 Tp) M^2 Tp floats
    (10 MB) of every Taylor power, squaring and tree level."""
    M, Tp, K, order, s = 12, 1024, 3, 6, 2
    g = _cuda.tree_geometry(M, Tp, K, order, s)
    shape = _cuda.residual_shape(M, Tp, K, order, s)
    assert shape == (256 + 8, M, M)
    floats = np.prod(shape)
    assert floats == (Tp // g.segment + g.blocks) * M * M
    per_step = (order - 1 + s + 10) * M * M * Tp
    assert 4 * floats == 152064 and floats * 60 < per_step


@pytest.mark.parametrize("order,s", [(2, 0), (6, 2), (20, 16)])
def test_residuals_do_not_grow_with_order_or_scaling(order, s):
    assert _cuda.residual_shape(4, 8192, 3, order, s) == (512 + 8, 4, 4)


def test_forward_allocates_E_and_the_products(recorded):
    rec, allocs = recorded
    K, M, Tp, order, s = 3, 8, 2048, 3, 1
    mats, w = empty_meta((K, M, M)), empty_meta((K, Tp))
    allocs.clear()
    E, res = _cuda.tree_forward(mats, w, order, s)
    assert allocs == [(M, M), (512 + 8, M, M)]
    assert tuple(res.shape) == _cuda.residual_shape(M, Tp, K, order, s)
    (name, args), = rec.calls
    assert name == "qoc_tree_forward"
    assert args[2:7] == (K, M, Tp, order, s)
    assert len(args) == 11 and args[9] is None      # clocks not asked for


def test_backward_allocates_wbar_only(recorded):
    rec, allocs = recorded
    K, M, Tp, order, s = 3, 8, 2048, 3, 1
    ops = (empty_meta((K, M, M)), empty_meta((K, Tp)),
           empty_meta(_cuda.residual_shape(M, Tp, K, order, s)),
           empty_meta((M, M)))
    allocs.clear()
    wbar = _cuda.tree_backward(*ops, order, s)
    assert allocs == [(K, Tp)] and tuple(wbar.shape) == (K, Tp)
    (name, args), = rec.calls
    assert name == "qoc_tree_backward" and len(args) == 12


def test_backward_refuses_other_residuals(recorded):
    """Residuals of another geometry (other lanes), or a gbar of another
    shape, raise before the launch."""
    rec, _ = recorded
    K, M, order, s = 3, 8, 3, 1
    res = empty_meta(_cuda.residual_shape(M, 1024, K, order, s))
    mats, gbar = empty_meta((K, M, M)), empty_meta((M, M))
    with pytest.raises(ValueError, match="do not match"):
        _cuda.tree_backward(mats, empty_meta((K, 64)), res, gbar, order, s)
    with pytest.raises(ValueError, match="do not match"):
        _cuda.tree_backward(mats, empty_meta((K, 1024)), res,
                            empty_meta((M, 1)), order, s)
    assert rec.calls == []


def test_clocks_are_one_row_per_block(recorded):
    rec, _ = recorded
    K, M, Tp, order, s = 3, 4, 1024, 2, 0
    G = _cuda.tree_geometry(M, Tp, K, order, s).blocks
    mats, w = empty_meta((K, M, M)), empty_meta((K, Tp))
    with pytest.raises(ValueError, match="clocks"):
        _cuda.tree_forward(mats, w, order, s, clocks=torch.zeros(
            (G - 1, 3), dtype=torch.int64, device="meta"))
    _cuda.tree_forward(mats, w, order, s, clocks=torch.zeros(
        (G, 3), dtype=torch.int64, device="meta"))
    assert rec.calls[-1][1][9] is not None


def test_clock_phases_of_kernels_1_and_2():
    assert _cuda.TREE_FWD_CLOCK_PHASES == ("walks", "block_tree", "cluster")
    assert _cuda.TREE_BWD_CLOCK_PHASES == (
        "block_tree", "cluster", "down_tree", "walks", "reverse_walks",
        "taylor_reverse")
    clocks = torch.zeros((8, 6), dtype=torch.int64)
    clocks[:, 4] = 30
    clocks[:, 5] = 10
    split = _cuda.clock_split(clocks, _cuda.TREE_BWD_CLOCK_PHASES)
    assert split["reverse_walks"] == pytest.approx(0.75)
    assert split["taylor_reverse"] == pytest.approx(0.25)


# ---- the association, against qoc_tpu's Pallas tree kernel ---------------

def _propagator(B, order, s):
    """(E_0, P): Horner on B (R <- I + B R / k, k = order .. 1; an order
    below 1 keeps I + B, as the plain version does), then s squarings, as
    each team forms P_t."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype)
    H = eye.clone()
    for k in range(max(order, 1), 0, -1):
        H = eye + (B @ H) / k
    P = H
    for _ in range(s):
        P = P @ P
    return H, P


def _step_reverse(B, E0, Pbar, order, s):
    """Abar_B of one step: the squarings reversed (each E_j recomputed from
    E_0 by j squarings), then Horner on [[B^T, G], [0, B^T]]."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype)
    G = Pbar
    for j in range(s - 1, -1, -1):
        Ej = E0
        for _ in range(j):
            Ej = Ej @ Ej
        G = G @ Ej.T + Ej.T @ G
    X = B.T
    R11, R12 = eye, torch.zeros_like(B)
    for k in range(max(order, 1), 0, -1):
        R12, R11 = (X @ R12 + G @ R11) / k, eye + X @ R11 / k
    return R12


def _levels(Q):
    """The pairwise tree over a block's segment products (later on the
    left): level l + 1 = level l [1::2] @ level l [0::2]."""
    levels = [Q]
    while levels[-1].shape[0] > 1:
        q = levels[-1]
        levels.append(q[1::2] @ q[0::2])
    return levels


def kernel_model(mats, w, order, s, G, S, gbar):
    """Kernels 1-2's association for one problem: mats [K, M, M], w [K, Tp]
    (padded lanes zero), G blocks of Tp / (G S) teams of S lanes each.
    Returns (E, wbar [K, Tp])."""
    K, M, _ = mats.shape
    Tp = w.shape[1]
    TB = Tp // G
    nseg = TB // S
    scale = 2.0 ** -s
    B = torch.einsum("kt,kij->tij", w * scale, mats)
    steps = [_propagator(B[t], order, s) for t in range(Tp)]
    eye = torch.eye(M, dtype=mats.dtype)

    def lanes(b, j):
        return range(b * TB + j * S, b * TB + (j + 1) * S)

    # kernel 1: segment walks, a tree per block, the cluster in rank order
    trees = []
    for b in range(G):
        Q = []
        for j in range(nseg):
            X = eye
            for t in lanes(b, j):
                X = steps[t][1] @ X
            Q.append(X)
        trees.append(_levels(torch.stack(Q)))
    C = [tr[-1][0] for tr in trees]
    E = eye
    for b in range(G):
        E = C[b] @ E
    # kernel 2: block prefixes and nu, down the tree, the segment walks
    wbar = torch.zeros_like(w)
    for b in range(G):
        X0 = eye
        for c in C[:b]:
            X0 = c @ X0
        nu = gbar
        for c in reversed(C[b + 1:]):
            nu = c.T @ nu
        start, end = [X0], [nu]
        levels = trees[b]
        for lv in reversed(levels[:-1]):
            start = [x for i, a in enumerate(start)
                     for x in (a, lv[2 * i] @ a)]
            end = [x for i, a in enumerate(end)
                   for x in (lv[2 * i + 1].T @ a, a)]
        for j in range(nseg):
            ts = list(lanes(b, j))
            Xs = [start[j]]
            for t in ts[:-1]:
                Xs.append(steps[t][1] @ Xs[-1])
            nu = end[j]
            for q in range(S - 1, -1, -1):
                t = ts[q]
                E0, P = steps[t]
                Pbar = nu @ Xs[q].T
                nu = P.T @ nu
                Abar = _step_reverse(B[t], E0, Pbar, order, s) * scale
                wbar[:, t] = torch.einsum("kij,ij->k", mats, Abar)
    return E, wbar


def _problem(M, order, s, K=3, Tp=64, seed=0):
    """Near-unitary steps (iso(-i dt H), dt small): mats [K, M, M], w [K,
    T] with T = Tp - 1 (one padded lane), R [M, M]."""
    rng = np.random.default_rng(seed + 10 * M + order)
    n = M // 2
    mats = []
    for _ in range(K):
        h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        h = -1j * 0.2 * (h + h.conj().T) / 2
        mats.append(np.block([[h.real, -h.imag], [h.imag, h.real]]))
    mats = np.stack(mats).astype(np.float32)
    w = rng.standard_normal((K, Tp - 1)).astype(np.float32)
    w[0] = 1.0
    R = rng.standard_normal((M, M)).astype(np.float32)
    return mats, w, R


@functools.lru_cache(maxsize=None)
def _qoc_tpu(M, order, s):
    """qoc_tpu's E and dL/dw (L = <R, E>), interpreted on the CPU."""
    mats, w, R = _problem(M, order, s)
    E, vjp = jax.vjp(lambda w_: j_tree(jnp.asarray(mats), w_, order, s),
                     jnp.asarray(w))
    (g,) = vjp(jnp.asarray(R))
    return np.asarray(E), np.asarray(g)


@pytest.mark.parametrize("M", [4, 12])
@pytest.mark.parametrize("order,s", [(2, 0), (4, 1), (6, 2), (0, 1)])
@pytest.mark.parametrize("G,S", [(1, 1), (2, 2), (4, 1), (4, 2), (2, 8)])
def test_association_matches_qoc_tpu(G, S, order, s, M):
    """E and the weight gradient by the kernels' association agree with
    qoc_tpu's fused tree chain at phase 2's bars (forward rel 2e-5,
    gradient rtol 1e-4 / atol 1e-5); order 0 keeps the first power, as
    qoc_tpu's does."""
    mats, w, R = _problem(M, order, s)
    E_want, g_want = _qoc_tpu(M, order, s)
    T = w.shape[1]
    wp = torch.nn.functional.pad(torch.from_numpy(w), (0, 1))
    E, wbar = kernel_model(torch.from_numpy(mats), wp, order, s, G, S,
                           torch.from_numpy(R))
    rel = np.abs(E.numpy() - E_want).max() / np.abs(E_want).max()
    assert rel <= 2e-5, rel
    np.testing.assert_allclose(wbar[:, :T].numpy(), g_want, rtol=1e-4,
                               atol=1e-5)


def test_association_model_is_not_trivially_the_plain_tree():
    """The model's products take another association than the plain
    version's pairwise tree over Taylor steps (Horner and segment walks):
    at G = 4, S = 2 its E differs from the plain tree's in the last bits,
    while both sit at the float32 floor of a float64 chain."""
    mats, w, R = _problem(4, 6, 2)
    wp = torch.nn.functional.pad(torch.from_numpy(w), (0, 1))
    mt = torch.from_numpy(mats)
    E, _ = kernel_model(mt, wp, 6, 2, 4, 2, torch.from_numpy(R))
    plain = tree_chain_reference(mt, wp, 6, 2)
    E64 = tree_chain_reference(mt.double(), wp.double(), 6, 2)
    assert not torch.equal(E, plain)
    assert (E.double() - E64).abs().max() <= 2e-6 * E64.abs().max()
    assert (plain.double() - E64).abs().max() <= 2e-6 * E64.abs().max()
