"""Chain product of per-step Taylor propagators (port of
``qoc_tpu.ops.pallas_tree``).

    E_total = P_{T-1} @ ... @ P_0,   P_t = Taylor_order(A_t / 2^s)^(2^s),
    A_t = sum_k w[k, t] mats[k]

``fused_tree_chain`` runs it on the card through the hand-written CUDA
kernels of ``csrc/tree_chain.cu`` (forward: teams of lanes walk segments
of steps, a tree per block, the cluster's products; backward: the prefixes
and cotangents down the same tree, the squarings and the Taylor series
reversed per step), wrapped in a ``torch.autograd.Function`` that is
differentiable in the weights.
``tree_chain_reference`` is the plain torch version of the same function:
the same zero padding to a power of two and the same factor order, with
autograd for the gradient.  The wrapper uses the plain version for CPU
tensors only; for CUDA tensors it launches the kernels or raises.

Serves both propagation modes: unitary (order=taylor_terms, scaling) and
state-transfer finals (order=taylor_terms-1, scaling=0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .expm import taylor_expm, weighted_hamiltonians


def next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def levels(Tp: int) -> int:
    return int(Tp).bit_length() - 1


def tree_chain_supported(M_real: int, steps: int) -> bool:
    """qoc_tpu's admission rule, kept so both packages route alike:
    M_real <= 12 and residuals under 10 MB.  The rule was sized for TPU
    VMEM; the H100 kernels keep only segment and block products, and take
    every shape it admits (``_cuda.tree_geometry``)."""
    MM = M_real * M_real
    Tp = next_pow2(max(steps, 2))
    bufs = (4 + levels(Tp)) * MM * Tp * 4
    return MM <= 144 and bufs < 10 * (1 << 20)


def _pad_lanes(weights: torch.Tensor) -> torch.Tensor:
    """Zero-pad ALL weight rows (the drift row too) to Tp lanes, so every
    padded lane's propagator is exp(0) = I."""
    T = weights.shape[1]
    return F.pad(weights, (0, next_pow2(max(T, 2)) - T))


def tree_chain_reference(mats: torch.Tensor, weights: torch.Tensor,
                         order: int, scaling: int) -> torch.Tensor:
    """Plain torch: batched Taylor over the padded lanes, then the pairwise
    tree (level l multiplies X[t + 2^l] @ X[t]).  mats [K, M, M], weights
    [K, T] -> [M, M]."""
    X = taylor_expm(weighted_hamiltonians(mats, _pad_lanes(weights)), order,
                    scaling)
    while X.shape[0] > 1:
        X = torch.matmul(X[1::2], X[0::2])
    return X[0]


def _entry(x: torch.Tensor, bdim, b: int) -> torch.Tensor:
    """Entry ``b`` of a vmapped operand (``bdim`` None: shared by all)."""
    return x if bdim is None else x.select(bdim, b)


class _TreeBackward(torch.autograd.Function):
    """Kernel 2: the padded weights, the residuals of kernel 1 and gbar
    [M, M] -> wbar [K, Tp].  A Function of its own, so that a vmapped
    gradient reaches the kernel through the vmap rule below (a raw launch
    cannot be vmapped)."""

    @staticmethod
    def forward(mats, w, res, gbar, order, scaling):
        return _cuda.tree_backward(*(x.contiguous() for x in (
            mats, w, res, gbar)), order, scaling)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused_tree_chain is differentiable once (no second derivative)")

    @staticmethod
    def vmap(info, in_dims, mats, w, res, gbar, order, scaling):
        # kernel 2 takes one problem: one launch per batch entry
        ops = (mats, w, res, gbar)
        wbar = torch.stack([
            _TreeBackward.apply(*(_entry(x, d, b) for x, d in zip(ops,
                                                                  in_dims)),
                                order, scaling)
            for b in range(info.batch_size)])
        return wbar, 0


class _TreeChain(torch.autograd.Function):
    """Kernels 1 and 2: the forward returns the residuals (the segment and
    block products) beside E, marked non-differentiable; the backward
    replays them with the padded weights.  A new-style Function with a
    vmap rule, so that it runs under ``torch.func`` (the batch layer's
    vmapped backend): kernel 1 takes one problem, so the rule launches it
    once per batch entry and stacks the results."""

    @staticmethod
    def forward(mats, weights, order, scaling):
        return _cuda.tree_forward(mats.contiguous(),
                                  _pad_lanes(weights).contiguous(), order,
                                  scaling)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mats, weights, order, scaling = inputs
        _, res = output
        ctx.mark_non_differentiable(res)
        ctx.save_for_backward(mats, weights, res)
        ctx.order, ctx.scaling = order, scaling

    @staticmethod
    def backward(ctx, gbar, _res_bar):
        mats, weights, res = ctx.saved_tensors
        wbar = _TreeBackward.apply(mats, _pad_lanes(weights), res, gbar,
                                   ctx.order, ctx.scaling)
        return None, wbar[..., :weights.shape[-1]], None, None

    @staticmethod
    def vmap(info, in_dims, mats, weights, order, scaling):
        outs = [_TreeChain.apply(_entry(mats, in_dims[0], b),
                                 _entry(weights, in_dims[1], b), order,
                                 scaling)
                for b in range(info.batch_size)]
        return tuple(torch.stack(xs) for xs in zip(*outs)), (0, 0)


def fused_tree_chain(mats: torch.Tensor, weights: torch.Tensor, order: int,
                     scaling: int) -> torch.Tensor:
    """Full chain product E_total [M, M] = P_{T-1} @ ... @ P_0.

    mats [K, M, M] (row 0 = drift, constant), weights [K, T] (row 0 = 1);
    powers 0..order kept, ``scaling`` squarings.  Differentiable in
    ``weights`` (exact), also under ``torch.func`` transforms; ``mats``
    gets no gradient on the kernel path.
    """
    if weights.device.type == "cpu":
        return tree_chain_reference(mats, weights, order, scaling)
    return _TreeChain.apply(mats, weights, order, scaling)[0]
