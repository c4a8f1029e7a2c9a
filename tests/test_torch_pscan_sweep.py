"""The pscan engine's sweeps around their CUDA kernels, on the CPU.

The kernels (``csrc/pscan_sweep.cu``) run on the card only, where they
decide which launch a shape takes (``tests_gpu/test_pscan_on_gpu.py``
holds them to float64 loops and checks every shape the pscan ladder
sends).  Here: the CPU's sweeps, which keep the plain loop with its bits;
and the card's route with stand-in launchers (``_on_card`` patched), where
every float32 shape and every vmapped batch reaches one launch and the
loop never runs, and a tensor the kernels cannot take raises.
"""

import numpy as np
import pytest
import torch

from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.ops import propagation as prop

torch.set_num_threads(1)

# the real launchers, whatever a test patches
_LAUNCHERS = (_cuda.pscan_forward, _cuda.pscan_reverse)


def _parent_sweep(Q, psi0, reps):
    """The forward loop as the port ran it before the kernels."""
    psi = psi0
    vecs = [psi0]
    for Qt in Q.unbind(0):
        for _ in range(reps):
            psi = torch.matmul(Qt, psi)
            vecs.append(psi)
    return torch.stack(vecs)


def _parent_reverse(Q, g, reps):
    """The adjoint loop as the port ran it before the kernels."""
    T = Q.shape[0]
    gsub = g[1:]
    QT = Q.mT.unbind(0)
    mu = torch.zeros_like(g[0])
    lams = [None] * (T * reps)
    for i in range(T * reps - 1, -1, -1):
        lam = mu + gsub[i]
        lams[i] = lam
        mu = torch.matmul(QT[i // reps], lam)
    return torch.stack(lams).reshape(T, reps, *g.shape[1:]), mu + g[0]


def _operands(T, M, V, reps, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Q = torch.tensor((np.eye(M) + 0.1 * rng.standard_normal((T, M, M)))
                     .astype(dtype))
    psi0 = torch.tensor(rng.standard_normal((M, V)).astype(dtype))
    g = torch.tensor(rng.standard_normal((T * reps + 1, M, V)).astype(dtype))
    return Q, psi0, g


@pytest.mark.parametrize("M, V, reps", [(16, 1, 1), (16, 3, 2), (10, 2, 1)])
def test_cpu_sweeps_keep_the_plain_loop_bits(M, V, reps):
    """On the CPU both sweeps are the plain loops, bit for bit as before
    the kernels; nothing is launched."""
    Q, psi0, g = _operands(7, M, V, reps)
    _cuda.reset_launch_counts()
    vecs = prop.pscan_sweep(Q, psi0, reps)
    lams, bar = prop.pscan_reverse_sweep(Q, g, reps)
    assert torch.equal(vecs, _parent_sweep(Q, psi0, reps))
    want_l, want_b = _parent_reverse(Q, g, reps)
    assert torch.equal(lams, want_l) and torch.equal(bar, want_b)
    assert _cuda.LAUNCHES["pscan_forward"] == 0
    assert _cuda.LAUNCHES["pscan_reverse"] == 0


def stand_in_launchers(monkeypatch, calls):
    """The card's route on the CPU: ``_on_card`` true, and the launchers
    replaced by the plain loops with their signatures (an operand without
    the seeds dimension is every seed's), counting their calls; the
    module's own loops then raise, as the route must never run them."""
    sweep, reverse_sweep = prop.pscan_sweep_plain, prop.pscan_reverse_plain

    def forward(Q, psi0, reps, seeds=1):
        calls["pscan_forward"].append(seeds)
        Q = Q if Q.dim() == 4 else Q.expand(seeds, *Q.shape)
        psi0 = psi0 if psi0.dim() == 3 else psi0.expand(seeds, *psi0.shape)
        return sweep(Q, psi0, reps)

    def reverse(Q, g, reps, seeds=1):
        calls["pscan_reverse"].append(seeds)
        Q = Q if Q.dim() == 4 else Q.expand(seeds, *Q.shape)
        g = g if g.dim() == 4 else g.expand(seeds, *g.shape)
        lams, bar = reverse_sweep(Q, g, reps)
        return lams.flatten(1, 2), bar

    def never(*args):
        raise AssertionError("the plain loop ran on the card's route")

    monkeypatch.setattr(prop, "_on_card", lambda x: True)
    monkeypatch.setattr(_cuda, "pscan_forward", forward)
    monkeypatch.setattr(_cuda, "pscan_reverse", reverse)
    monkeypatch.setattr(prop, "pscan_sweep_plain", never)
    monkeypatch.setattr(prop, "pscan_reverse_plain", never)


# (T, M, V, reps): config 4's width, the tiles of V past 8 (balanced, with
# sub-steps), odd M, M past the on-chip form's 512, a unitary chain
ROUTE_SHAPES = {"m16": (5, 16, 2, 1), "v9": (5, 16, 9, 1),
                "v13_reps2": (4, 16, 13, 2), "odd_m": (5, 15, 2, 1),
                "wide": (3, 520, 1, 1), "unitary": (4, 16, 3, 4)}


@pytest.mark.parametrize("name", list(ROUTE_SHAPES))
def test_the_card_route_launches_every_float32_shape(name, monkeypatch):
    """On the card's route every float32 shape, whatever M, V or reps,
    reaches one launch a sweep (the launch decides how it runs it), with
    the launchers' outputs handed back unchanged."""
    calls = {"pscan_forward": [], "pscan_reverse": []}
    T, M, V, reps = ROUTE_SHAPES[name]
    Q, psi0, g = _operands(T, M, V, reps, seed=1)
    stand_in_launchers(monkeypatch, calls)
    vecs = prop.pscan_sweep(Q, psi0, reps)
    lams, bar = prop.pscan_reverse_sweep(Q, g, reps)
    assert calls == {"pscan_forward": [1], "pscan_reverse": [1]}
    monkeypatch.undo()
    assert torch.equal(vecs, _parent_sweep(Q, psi0, reps))
    want_l, want_b = _parent_reverse(Q, g, reps)
    assert torch.equal(lams, want_l) and torch.equal(bar, want_b)


@pytest.mark.parametrize("dims", [(0, None), (None, 0), (0, 0)],
                         ids=["q_batched", "x_batched", "both"])
def test_a_vmapped_batch_on_the_card_route_is_one_launch(dims, monkeypatch):
    """Under ``vmap`` on the card's route the seeds reach one launch a
    direction (Q per seed and psi0 or g shared, the other way round, both
    per seed), and each seed gets its own sweep's bits."""
    calls = {"pscan_forward": [], "pscan_reverse": []}
    S, T, M, V, reps = 3, 4, 16, 2, 2
    rng = np.random.default_rng(7)

    def make(shape, batched):
        x = rng.standard_normal(((S,) if batched else ()) + shape)
        return torch.tensor(x.astype(np.float32))

    Q = torch.eye(M) + 0.1 * make((T, M, M), dims[0] == 0)
    psi0 = make((M, V), dims[1] == 0)
    g = make((T * reps + 1, M, V), dims[1] == 0)
    stand_in_launchers(monkeypatch, calls)
    vecs = torch.func.vmap(prop.pscan_sweep, in_dims=(*dims, None))(
        Q, psi0, reps)
    lams, bar = torch.func.vmap(prop.pscan_reverse_sweep,
                                in_dims=(*dims, None))(Q, g, reps)
    assert calls == {"pscan_forward": [S], "pscan_reverse": [S]}
    monkeypatch.undo()
    for s in range(S):
        Qs = Q[s] if dims[0] == 0 else Q
        xs, gs = (psi0[s], g[s]) if dims[1] == 0 else (psi0, g)
        assert torch.equal(vecs[s], _parent_sweep(Qs, xs, reps))
        want_l, want_b = _parent_reverse(Qs, gs, reps)
        assert torch.equal(lams[s], want_l) and torch.equal(bar[s], want_b)


@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_a_tensor_the_kernels_cannot_take_raises_on_the_card_route(
        dtype, monkeypatch):
    """A sweep on the card's route whose operands the kernels cannot take
    (not float32; on the CPU, not on the card either) raises from the
    launcher's checks, and the plain loop never runs in its place."""
    Q, psi0, g = _operands(5, 16, 2, 1, seed=2, dtype=dtype)
    calls = {"pscan_forward": [], "pscan_reverse": []}
    stand_in_launchers(monkeypatch, calls)
    monkeypatch.setattr(_cuda, "pscan_forward", _LAUNCHERS[0])
    monkeypatch.setattr(_cuda, "pscan_reverse", _LAUNCHERS[1])
    with pytest.raises(ValueError, match="CUDA kernel operand"):
        prop.pscan_sweep(Q, psi0, 1)
    with pytest.raises(ValueError, match="CUDA kernel operand"):
        prop.pscan_reverse_sweep(Q, g, 1)

