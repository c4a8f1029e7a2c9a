"""The pscan engine's sweep kernels (``csrc/pscan_sweep.cu``) on the card.

Both sweeps against a float64 run of their plain loops
(``pscan_sweep_plain``, ``pscan_reverse_plain``), each held to the float32
floor (the plain loop's own float32 gap, times four), at shapes of both
forms: on chip, config 4's shape, config 5's, a unitary shape with 2^2
sub-steps a step and V = 5, a cluster of two blocks at M = 2 mod 4, the
chunked ring at M = 512 and 13 columns in two tiles; through L2, M = 1024,
an odd M, the ring's M with sub-steps, and M = 4096 at the pscan ladder's
cap.  A second launch gives the same bits; a vmapped batch of seeds is one
launch with each seed's bits (on chip, and through L2 with more seeds
than the grid's groups); ``vmap(grad)`` through ``pscan_chain`` against the eager
per-seed gradient; a ``Grape`` solve of config 4 routes every sweep to the
kernels; and the library takes every shape the ladder sends, within its
shared memory, and refuses a float64 tensor without running the loop.
"""

import json
import os

import numpy as np
import pytest
import torch

from conftest import gap, launches

import qoc_tpu_torch as q
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.ops.propagation import (
    pscan_chain, pscan_reverse_plain, pscan_reverse_sweep, pscan_sweep,
    pscan_sweep_plain)

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (T, M, V, reps): on chip, config 4, config 5, a unitary chain (V + 1
# columns, scaling 2), two blocks at M = 154, the chunked ring at M = 512,
# two tiles of columns with sub-steps; through L2, M = 1024, an odd M, M =
# 512 with sub-steps (no ring), and M = 4096 (the ladder sends it up to T =
# 15)
SHAPES = {"config4": (1000, 120, 1, 1), "config5": (200, 400, 1, 1),
          "unitary": (128, 64, 5, 4), "cluster2": (64, 154, 3, 1),
          "chunked": (32, 512, 2, 1), "tiles": (40, 64, 13, 2),
          "wide": (12, 1024, 3, 1), "odd": (50, 121, 2, 1),
          "wide_reps": (6, 512, 2, 2), "m4096": (2, 4096, 1, 1)}


def _propagators(T: int, M: int, seed: int, device, seeds=None):
    """Q [(seeds,) T, M, M] in float32: random real orthogonal steps, so
    long chains stay bounded: the Q factors of Gaussian matrices (on the
    host) up to M = 512, past it the product of two random reflections,
    dense and not symmetric, at O(M^2) a step."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lead = (T,) if seeds is None else (seeds, T)
    if M <= 512:
        A = torch.randn(lead + (M, M), generator=gen, dtype=torch.float64)
        return torch.linalg.qr(A).Q.float().to(device)
    a, b = torch.randn((2,) + lead + (M, 1), generator=gen,
                       dtype=torch.float64)
    a, b = a / a.norm(dim=-2, keepdim=True), b / b.norm(dim=-2, keepdim=True)
    eye = torch.eye(M, dtype=torch.float64)
    Q = (eye - 2 * a @ a.mT) @ (eye - 2 * b @ b.mT)
    return Q.float().to(device)


def _random(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device)


@pytest.mark.parametrize("name", list(SHAPES))
def test_sweeps_hold_the_float32_floor(name, device, record_property):
    """Each sweep against the float64 loop on the same float32 operands:
    the kernel's largest gap at most four times the float32 loop's; one
    launch a sweep; a second launch gives the same bits."""
    T, M, V, reps = SHAPES[name]
    Q = _propagators(T, M, 11, device)
    psi0 = _random((M, V), 12, device)
    g = _random((T * reps + 1, M, V), 13, device)
    _cuda.reset_launch_counts()
    with launches(device, "pscan_forward", "pscan_reverse") as got:
        vecs = pscan_sweep(Q, psi0, reps)
        lams, bar = pscan_reverse_sweep(Q, g, reps)
        again = (pscan_sweep(Q, psi0, reps), *pscan_reverse_sweep(Q, g, reps))
    if device.type == "cuda":
        assert got["pscan_forward"] == 2 and got["pscan_reverse"] == 2
    for a, b in zip((vecs, lams, bar), again):
        assert torch.equal(a, b)
    want_v = pscan_sweep_plain(Q.double(), psi0.double(), reps)
    want_l, want_b = pscan_reverse_plain(Q.double(), g.double(), reps)
    plain_v = pscan_sweep_plain(Q, psi0, reps)
    plain_l, plain_b = pscan_reverse_plain(Q, g, reps)
    for tag, got_, plain, want in (("vecs", vecs, plain_v, want_v),
                                   ("lams", lams, plain_l, want_l),
                                   ("psi0_bar", bar, plain_b, want_b)):
        assert got_.shape == want.shape
        k, f = gap(got_.cpu(), want.cpu()), gap(plain.cpu(), want.cpu())
        record_property(f"{tag}_gap", k)
        record_property(f"{tag}_float32_floor", f)
        assert k <= 4 * f + 1e-7, (tag, k, f)


def test_a_vmapped_batch_is_one_launch(device):
    """vmap over 4 seeds (Q per seed, psi0 shared; Q shared, g per seed)
    on chip, and on the card over 200 seeds at an odd M (through L2: more
    seeds than the grid's groups, each sweeping several in turn): one
    launch a direction, and each seed's bits as its own launch."""
    _vmapped_batch(300, 120, 2, 1, 4, device)
    if device.type == "cuda":   # the CPU's batched products round apart
        _vmapped_batch(4, 121, 1, 1, 200, device)


def _vmapped_batch(T, M, V, reps, S, device):
    Q = _propagators(T, M, 21, device, seeds=S)
    psi0 = _random((M, V), 22, device)
    g = _random((S, T * reps + 1, M, V), 23, device)
    with launches(device, "pscan_forward", "pscan_reverse") as got:
        vecs = torch.func.vmap(pscan_sweep, in_dims=(0, None, None))(
            Q, psi0, reps)
        lams, bar = torch.func.vmap(pscan_reverse_sweep,
                                    in_dims=(None, 0, None))(Q[0], g, reps)
    if device.type == "cuda":
        assert got["pscan_forward"] == 1 and got["pscan_reverse"] == 1
    for s in range(S):
        assert torch.equal(vecs[s], pscan_sweep(Q[s], psi0, reps))
        one_l, one_b = pscan_reverse_sweep(Q[0], g[s], reps)
        assert torch.equal(lams[s], one_l) and torch.equal(bar[s], one_b)


def test_vmapped_gradient_through_pscan_chain(device, record_property):
    """vmap(grad) through ``pscan_chain`` over 3 seeds' weights at M = 120
    against each seed's eager ``autograd.grad``: one launch a direction
    for the batch, gradients within 1e-5 of their largest entry."""
    S, K, M, T, V, order = 3, 3, 120, 200, 1, 10
    mats = _random((K, M, M), 31, device) * 0.02
    mats = mats - mats.mT                   # antisymmetric generators
    w = _random((S, K, T), 32, device)
    psi0 = _random((M, V), 33, device)
    R = _random((T + 1, M, V), 34, device)

    def loss(w_):
        return torch.sum(pscan_chain(mats, w_, psi0, order, 1) * R)

    with launches(device, "pscan_forward", "pscan_reverse") as got:
        batch = torch.func.vmap(torch.func.grad(loss))(w)
    if device.type == "cuda":
        assert got["pscan_forward"] == 1 and got["pscan_reverse"] == 1
    worst = 0.0
    for s in range(S):
        ws = w[s].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(loss(ws), ws)
        worst = max(worst, gap(batch[s].cpu(), want.cpu())
                    / float(want.abs().max()))
    record_property("grad_rel_gap", worst)
    assert worst <= 1e-5


def test_grape_config4_routes_every_sweep_to_the_kernels(device,
                                                         record_property):
    """Config 4 (the published job) through ``Grape`` for 5 iterations:
    the pscan engine, both sweeps of every loss-and-gradient in the
    kernels (one launch a direction)."""
    from qoc_tpu_torch.utils.jobs import load_job

    if device.type != "cuda":
        pytest.skip("the routing is the card's only: the CPU runs the loops")
    job = load_job(os.path.join(ROOT, "examples", "jobs",
                                "transmon_cavity.json"))
    job.update(save=False, device=device, method="Adam", engine="auto",
               show_plots=False)
    job["convergence"] = dict(job["convergence"], max_iterations=5)
    _cuda.reset_launch_counts()
    res = q.Grape(**job)
    counts = {k: _cuda.LAUNCHES[k] for k in ("pscan_forward",
                                             "pscan_reverse")}
    record_property("launches", json.dumps(counts))
    assert res.engine == "pscan"
    # a loss-and-gradient each of iterations 0..5, one forward more for
    # the final readout
    assert counts["pscan_reverse"] == res.iterations + 1, counts
    assert counts["pscan_forward"] == counts["pscan_reverse"] + 1, counts


def test_the_launch_takes_every_shape_the_ladder_sends(device):
    """The library's geometry (what the launch runs, whatever the number
    of seeds) over the shapes the pscan ladder sends (M >= 16 with 8 T
    reps M^2 < 2^31, any V): every one taken; a tile of at most 8 columns,
    the tiles cover V; the group's blocks cover M; shared memory in
    bounds; on chip, at least two ring stages, every copy's offset and
    size a multiple of 16 bytes.  A float64 sweep on the card raises, and
    the plain loop does not run in its place."""
    if device.type != "cuda":
        pytest.skip("the library is built on the card only")
    from qoc_tpu_torch.ops import propagation as prop

    for M in (16, 30, 120, 122, 150, 152, 154, 256, 400, 472, 510, 512,
              514, 1000, 1024, 2048, 4094, 8192, 16382):
        T_most = ((1 << 31) - 1) // (8 * M * M)
        for reps in (1, 2, 16):
            if T_most // reps < 1:
                continue
            for V in (1, 2, 5, 8, 9, 13, 61):
                for rev in (False, True):
                    g = _cuda.pscan_geometry(M, V, reps, rev)
                    key = (M, V, reps, rev)
                    assert g is not None, key
                    assert 1 <= g.vt <= 8, key
                    assert g.tiles * g.vt >= V > (g.tiles - 1) * g.vt, key
                    assert (g.cluster - 1) * g.rows < M <= (
                        g.cluster * g.rows), key
                    assert 0 < g.smem <= 232448, key
                    if g.wide:
                        continue
                    assert M % 2 == 0 and g.rows % 2 == 0, key
                    assert 2 <= g.stages <= 8, key
                    assert (g.chunk * M * 4) % 16 == 0, key
                    assert g.chunks == 1 or (g.chunk % 4 == 0
                                             and reps == 1), key
    Q = _propagators(5, 16, 41, device).double()
    psi0 = _random((16, 1), 42, device).double()

    def never(*args):
        raise AssertionError("the plain loop ran on the card")

    plain = prop.pscan_sweep_plain
    prop.pscan_sweep_plain = never
    try:
        with pytest.raises(ValueError, match="float32"):
            pscan_sweep(Q, psi0, 1)
    finally:
        prop.pscan_sweep_plain = plain
