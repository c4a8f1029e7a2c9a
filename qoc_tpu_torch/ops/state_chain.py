"""Column-batched state chain (port of ``qoc_tpu.ops.pallas_chain``).

    psi_{t+1} = step_t psi_t,  step_t = Taylor_order(A_t / 2^s)^(2^s),
    A_t = sum_k w[t, k, :] mats[k]

on a block of columns ``psi [M, C]`` (columns = seeds x concerned
vectors), every column with its own weights.  Each of the 2^s
applications of a step keeps Taylor powers 0..order-1 (the matvec
convention, tensorflow_state.py:77-97).

``fused_state_chain`` runs it on the card through kernels 4 and 5 of
``csrc/state_chain.cu`` (forward: the chain, keeping the trajectory;
backward: the exact reverse sweep, replaying each step from the
trajectory), in a ``torch.autograd.Function`` differentiable in ``w`` and
``psi0``; ``mats`` gets no gradient, as in qoc_tpu
(tensorflow_state.py:65,133).  ``state_chain_reference`` is the plain
torch version: the same recurrence as a loop over T, with autograd for
the gradient.  The wrappers use the plain version for CPU tensors only;
for CUDA tensors they launch the kernels or raise.  Unlike qoc_tpu, the
column count need not be a multiple of 128 (a TPU tiling rule).
"""

from __future__ import annotations

import torch

from . import _cuda


def _apply(mats: torch.Tensor, wt: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """sum_k wt[k, :] * (mats[k] @ x): mats [K, M, M], wt [K, C], x [M, C]."""
    return torch.einsum("kc,kmc->mc", wt, torch.matmul(mats, x))


def state_chain_reference(mats: torch.Tensor, w: torch.Tensor,
                          psi0: torch.Tensor, order: int, scaling: int = 0,
                          trajectory: bool = False):
    """Plain torch: mats [K, M, M], w [T, K, C], psi0 [M, C] -> psi_T
    [M, C], or (psi_T, trajectory [T+1, M, C]) with ``trajectory``."""
    reps = 1 << scaling
    csc = 1.0 / reps
    psi = psi0
    traj = [psi0]
    for t in range(w.shape[0]):
        wt = w[t]
        for _ in range(reps):
            pn = psi
            y = psi
            for n in range(1, order):
                pn = _apply(mats, wt, pn) * (csc / n)
                y = y + pn
            psi = y
        if trajectory:
            traj.append(psi)
    if trajectory:
        return psi, torch.stack(traj)
    return psi


class _StateChain(torch.autograd.Function):
    """Kernels 4 and 5: forward keeps the trajectory, backward replays it."""

    @staticmethod
    def forward(ctx, mats, w, psi0, order, scaling):
        mats, w = mats.contiguous(), w.contiguous()
        out, traj = _cuda.state_chain_forward(mats, w, psi0.contiguous(),
                                              order, scaling)
        ctx.save_for_backward(mats, w, traj)
        ctx.order, ctx.scaling = order, scaling
        return out

    @staticmethod
    def backward(ctx, gbar):
        mats, w, traj = ctx.saved_tensors
        wbar, psibar = _cuda.state_chain_backward(
            mats, w, traj, gbar.contiguous(), ctx.order, ctx.scaling)
        return None, wbar, psibar, None, None


def fused_state_chain(mats: torch.Tensor, w: torch.Tensor,
                      psi0: torch.Tensor, order: int,
                      scaling: int = 0) -> torch.Tensor:
    """Final state psi_T [M, C] of the chain (qoc_tpu's
    ``fused_state_chain``).

    mats [K, M, M] (row 0 = drift), w [T, K, C] (w[:, 0, :] = 1), psi0
    [M, C]; powers 0..order-1, ``scaling`` squarings as repeated
    applications.  Differentiable in ``w`` and ``psi0`` (exact)."""
    if w.device.type == "cpu":
        return state_chain_reference(mats, w, psi0, order, scaling)
    return _StateChain.apply(mats, w, psi0, order, scaling)


def fused_state_chain_with_traj(mats: torch.Tensor, w: torch.Tensor,
                                psi0: torch.Tensor, order: int,
                                scaling: int = 0):
    """Forward only: (psi_T [M, C], trajectory [T+1, M, C]), not
    differentiable (qoc_tpu's ``fused_state_chain_with_traj``)."""
    if w.device.type == "cpu":
        with torch.no_grad():
            return state_chain_reference(mats, w, psi0, order, scaling,
                                         trajectory=True)
    return _cuda.state_chain_forward(mats.contiguous(), w.contiguous(),
                                     psi0.contiguous(), order, scaling)
