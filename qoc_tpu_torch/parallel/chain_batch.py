"""Seed-batched loss through the fused state chain (port of
``qoc_tpu.parallel.pallas_batch``, the ``"pallas"`` backend).

All seeds (x concerned vectors) ride the chain's column axis, c = seed *
V + v: each seed's weights repeat over its V columns and the
initial-vector block is tiled over the seeds.  On the card the chain is
kernel 4 with kernel 5 as its backward (``ops.state_chain``); the
coherent per-seed fidelity is reassembled in torch from the final
columns (pallas_batch.py:129-136), and the pulse penalties come from
``models.costs``.  Penalties that read the trajectory are outside this
backend, as in qoc_tpu.

Hamiltonian sweeps ride extra operator channels with a constant
per-seed weight (``extra_weights [S, E]``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..interop import problem_tensors
from ..models.costs import CostContext, total_reg_cost
from ..models.forward import INTER_VEC_COSTS
from ..ops import _cuda
from ..ops.state_chain import fused_state_chain
from .cols_batch import chain_inputs, chain_order, column_weights


def pallas_batch_supported(problem, reg_coeffs: Optional[dict]) -> bool:
    """qoc_tpu's gate: no penalty that reads intermediate states; state
    transfer or unitary mode at any taylor_scaling; and the CUDA chain's
    bounds (``_cuda.chain_fits``) in place of the TPU VMEM budget."""
    if any(k in (reg_coeffs or {}) for k in INTER_VEC_COSTS):
        return False
    return _cuda.chain_fits(problem.ops_len + 1, 2 * problem.state_num,
                            *chain_order(problem))


def make_pallas_batched_loss(problem, reg_coeffs: Optional[dict] = None,
                             extra_channel_mats=None, device="cpu"):
    """Build ``u_bases [S, Kc, T] -> (reg_losses [S], fid_losses [S])``;
    ``extra_channel_mats`` ([E, 2N, 2N]) adds channels whose per-seed
    weights ``extra_weights [S, E]`` are the second argument."""
    p = problem
    tens = problem_tensors(p, device)
    mats, psi0, order, scaling = chain_inputs(p, extra_channel_mats, device)
    tgt, max_amp = tens["target_vectors"], tens["ops_max_amp"]
    V = psi0.shape[1]
    N = p.state_num
    T = p.steps

    def seed_reg(w_s):
        ctx = CostContext(
            ops_weight=w_s, inter_vecs=None, target_vecs=tgt, state_num=N,
            steps=T, dt=p.dt, total_time=p.total_time,
            one_minus_gauss=tens["one_minus_gauss"], v_sorted_iso=None)
        return total_reg_cost(ctx, reg_coeffs)

    def batched_loss(u_bases: torch.Tensor, extra_weights=None):
        S = u_bases.shape[0]
        ops_weight, w = column_weights(u_bases, max_amp, extra_weights, V)
        out = fused_state_chain(mats, w, psi0.repeat(1, S), order, scaling)
        # coherent fidelity per seed (inner_product_2d semantics)
        tgt_cols = tgt.repeat(1, S)
        a, b = out[:N], out[N:]
        c, d = tgt_cols[:N], tgt_cols[N:]
        re = torch.sum(a * c + b * d, dim=0).reshape(S, V).sum(dim=1)
        im = torch.sum(b * c - a * d, dim=0).reshape(S, V).sum(dim=1)
        fid_losses = 1.0 - (re * re + im * im) / (V * V)
        reg_losses = fid_losses
        if reg_coeffs:
            reg_losses = fid_losses + torch.func.vmap(seed_reg)(ops_weight)
        return reg_losses, fid_losses

    return batched_loss
