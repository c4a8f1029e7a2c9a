"""Column-batched loss in plain torch (port of
``qoc_tpu.parallel.xla_batch``, the ``"xla-cols"`` backend).

Seeds ride the column axis: the state block is ``[M, C]`` (C = seeds x V
concerned vectors, c = seed * V + v) and each Taylor power is ONE
``[M, K'M] @ [K'M, C]`` product, the per-column weights folded into the
stacked operand (``sum_k w_k (M_k @ p) = [M_0|..|M_K'] @ stack_k(p * w_k)``).
No per-seed matrix exists, so this is the backend for large dimensions,
any V, and the reference that the fused batched-optimizer kernel's plain
version (``parallel.mega_batch``) differentiates.  The stacked product
stays ``torch.matmul``: a plain large product outside any kernel.

Scope as in qoc_tpu: state transfer or unitary mode at any
taylor_scaling (2^s pre-scaled applications per step), the coherent
group fidelity, the forbidden-level and speed_up penalties accumulated
inside the time loop (no stored trajectory), the pulse penalties through
``models.costs``, and constant-weight extra channels.  ``remat`` (on by
default, as in qoc_tpu) recomputes each time step in the backward pass, so
a loss-and-gradient keeps one ``[M, C]`` state a step instead of every
Taylor power.  qoc_tpu's 128-column padding (a TPU layout rule) is left
out.

``make_xla_cols_sharded_runner`` is qoc_tpu's pod path for large-dim
sweeps (BASELINE config 5): fixed-count Adam segments on each rank's
shard of the seeds, with no collective until the results are gathered.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..interop import entry_device, problem_tensors
from ..models.costs import CostContext, total_reg_cost
from ..models.forward import INTER_VEC_COSTS
from ..ops.mega import _MEGA_FORB_KEYS, forbidden_static
from ..ops.remat import recompute
from ..optim.adam import (batched_adam_update, decay_factor,
                          init_batch_adam)
from .mesh import gather, local_shard


def xla_cols_supported(problem, reg_coeffs: Optional[dict]) -> bool:
    """qoc_tpu's gate: any V; trajectory penalties need use_inter_vecs."""
    rc = reg_coeffs or {}
    if any(k in rc for k in INTER_VEC_COSTS) and not problem.use_inter_vecs:
        return False
    return True


def chain_order(problem):
    """(order, scaling) of the column chain: powers 0..taylor_terms-1
    without squaring in state transfer; powers 0..taylor_terms and
    taylor_scaling pre-scaled applications in unitary mode."""
    p = problem
    if p.state_transfer:
        return p.taylor_terms, 0
    return p.taylor_terms + 1, p.taylor_scaling


def chain_inputs(problem, extra_channel_mats=None, device="cpu",
                 dtype=torch.float32):
    """(mats [K', M, M], psi0 [M, V], order, scaling) of the column chain:
    extra channels appended to the problem's generators, and in unitary
    mode the columns starting at U0_iso @ psi0 (a float32 host product, as
    qoc_tpu forms it) with powers 0..taylor_terms."""
    p = problem
    mats = np.asarray(p.mats, dtype=np.float32)
    if extra_channel_mats is not None:
        mats = np.concatenate(
            [mats, np.asarray(extra_channel_mats, dtype=np.float32)])
    psi0 = np.asarray(p.initial_vectors, dtype=np.float32)
    if not p.state_transfer:
        psi0 = np.asarray(p.U0_iso, dtype=np.float32) @ psi0
    order, scaling = chain_order(p)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(
            dtype)

    return dev(mats), dev(psi0), order, scaling


def column_weights(u_bases, max_amp, extra_weights, V: int):
    """(ops_weight [S, Kc, T], w [T, K', C]): drift weight 1, the controls
    maxA * sin(u), the extra channels' constant weights, each seed's
    weights repeated over its V columns."""
    S, _, T = u_bases.shape
    ops_weight = torch.sin(u_bases)
    chans = [torch.ones((S, 1, T), dtype=u_bases.dtype,
                        device=u_bases.device),
             max_amp[None, :, None] * ops_weight]
    if extra_weights is not None:
        ew = torch.as_tensor(extra_weights, device=u_bases.device).to(
            u_bases.dtype)
        chans.append(ew[:, :, None].expand(S, ew.shape[1], T))
    w = torch.cat(chans, dim=1).permute(2, 1, 0)            # [T, K', S]
    if V > 1:
        w = torch.repeat_interleave(w, V, dim=2)
    return ops_weight, w


def make_xla_batched_loss(problem, reg_coeffs: Optional[dict] = None,
                          extra_channel_mats=None, remat: bool = True,
                          device="cpu", dtype=torch.float32):
    """Build ``u_bases [S, Kc, T] -> (reg_losses [S], fid_losses [S])``.

    ``extra_channel_mats`` ([E, 2N, 2N] real iso) adds fixed operator
    channels whose constant per-seed weights ``extra_weights [S, E]`` are
    the loss's second argument.  ``remat`` recomputes each time step in
    the backward pass (``ops.remat.recompute``; the stored powers at
    [order, M, C] a step would otherwise dominate memory at large M).
    ``dtype`` float64 gives the float64 reference of the same arithmetic.
    """
    p = problem
    rc = reg_coeffs or {}
    tens = {k: v.to(dtype) for k, v in problem_tensors(p, device).items()}
    mats, psi0, order, scaling = chain_inputs(p, extra_channel_mats, device,
                                              dtype)
    Kp, M = mats.shape[0], mats.shape[1]
    # horizontal stack [M, K'M]: mats_h[i, k*M + j] = mats[k, i, j]
    mats_h = mats.permute(1, 0, 2).reshape(M, Kp * M)
    tgt = tens["target_vectors"]
    V = psi0.shape[1]
    max_amp = tens["ops_max_amp"]
    N = p.state_num
    T = p.steps
    reps = 1 << scaling
    csc = 1.0 / reps
    forb, forb_c0 = forbidden_static(p, rc)
    if len(forb):
        f = torch.as_tensor(forb.astype(np.float32), device=device).to(dtype)
        f_alphas, f_rows_s, f_rows_ns = f[:, 0], f[:, 1:1 + M], f[:, 1 + M:]
    has_su = "speed_up" in rc
    if has_su:
        # per-step coherent target overlap in the loop carry: Re<psi|tgt>
        # = psi . tgt and Im<psi|tgt> = psi . [-d; c]; the t = 0 term reads
        # the RAW psi0 in both modes (tensorflow_state.py:229-242)
        su_alpha = float(rc["speed_up"]) / float(T)
        tgt_im_1 = torch.cat([-tgt[N:], tgt[:N]])
        psi0_raw = tens["initial_vectors"]
        re0 = torch.sum(psi0_raw * tgt)
        im0 = torch.sum(psi0_raw * tgt_im_1)
        su0 = (re0 * re0 + im0 * im0) * (1.0 / (V * V))
    pulse_rc = {k: v for k, v in rc.items()
                if k not in _MEGA_FORB_KEYS and k != "speed_up"}

    def seed_reg(w_s):
        ctx = CostContext(
            ops_weight=w_s, inter_vecs=None, target_vecs=tgt, state_num=N,
            steps=T, dt=p.dt, total_time=p.total_time,
            one_minus_gauss=tens["one_minus_gauss"], v_sorted_iso=None)
        return total_reg_cost(ctx, pulse_rc)

    def batched_loss(u_bases: torch.Tensor, extra_weights=None):
        S = u_bases.shape[0]
        C = S * V
        ops_weight, w_t = column_weights(u_bases, max_amp, extra_weights, V)
        psi = psi0.repeat(1, S)                              # [M, C]
        pen = torch.zeros(C, dtype=dtype, device=u_bases.device)
        if has_su:
            tgt_re = tgt.repeat(1, S)
            tgt_im = tgt_im_1.repeat(1, S)
            su = su0.expand(S)

        def step(psi, wt):
            """One time step: the state and this step's penalty terms."""
            for _ in range(reps):
                acc = psi
                pn = psi
                for n in range(1, order):
                    stacked = (pn[None] * wt[:, None, :]).reshape(Kp * M, C)
                    pn = torch.matmul(mats_h, stacked) * (csc / n)
                    acc = acc + pn
                psi = acc
            out = (psi,)
            if len(forb):
                phi_s = torch.matmul(f_rows_s, psi)
                phi_ns = torch.matmul(f_rows_ns, psi)
                pop = phi_s * phi_s + phi_ns * phi_ns            # [F, C]
                out += (torch.sum(f_alphas[:, None] * 0.5 * pop * pop,
                                  dim=0),)
            if has_su:
                re = torch.sum(psi * tgt_re, dim=0).reshape(S, V).sum(1)
                im = torch.sum(psi * tgt_im, dim=0).reshape(S, V).sum(1)
                out += ((re * re + im * im) * (1.0 / (V * V)),)
            return out

        for t in range(T):
            wt = w_t[t]
            out = recompute(step, psi, wt) if remat else step(psi, wt)
            psi = out[0]
            if len(forb):
                pen = pen + out[1]
            if has_su:
                su = su + out[-1]

        # coherent group fidelity over each seed's V columns
        # (get_inner_product_2D, tensorflow_state.py:282-300)
        a = psi[:N].reshape(N, S, V)
        b = psi[N:].reshape(N, S, V)
        c, d = tgt[:N], tgt[N:]
        re = (torch.einsum("nsv,nv->s", a, c)
              + torch.einsum("nsv,nv->s", b, d))
        im = (torch.einsum("nsv,nv->s", b, c)
              - torch.einsum("nsv,nv->s", a, d))
        fid_losses = 1.0 - (re * re + im * im) * (1.0 / (V * V))
        reg_losses = fid_losses
        if len(forb):
            reg_losses = reg_losses + pen.reshape(S, V).sum(1) + forb_c0
        if has_su:
            miss = float(T + 1) - su
            reg_losses = reg_losses + su_alpha * 0.5 * miss * miss
        if pulse_rc:
            reg_losses = reg_losses + torch.func.vmap(seed_reg)(ops_weight)
        return reg_losses, fid_losses

    return batched_loss


def make_xla_cols_sharded_runner(problem, conv, mesh,
                                 reg_coeffs: Optional[dict] = None,
                                 extra_channel_mats=None, device=None):
    """Fixed-count Adam segments on the column-batched loss, each rank on
    its shard of the seed axis (qoc_tpu/parallel/xla_batch.py:253-339).

    Returns ``run(u_bases [S, K, T], n, extra_weights [S, E] | None) ->
    (u' [S, K, T], losses [S], reg_losses [S])``: global arrays in, every
    rank keeps its slice (``parallel.mesh.local_shard``), runs ``n``
    complete Adam iterations from a fresh optimizer state with no
    collective, and returns the gathered global arrays.  The losses are
    taken at the pre-update iterate of the final iteration (zeros when
    ``n`` is 0).
    The loss recomputes each time step in the backward pass (qoc_tpu's
    default).  qoc_tpu's ``run.lower_segment`` (the XLA lowering of the
    segment) has nothing to lower in eager torch and is left out.
    ``device=None`` means the CUDA card.
    """
    device = entry_device(device)
    batched_loss = make_xla_batched_loss(
        problem, reg_coeffs, extra_channel_mats=extra_channel_mats,
        device=device)
    factor = decay_factor(conv)

    def local(x):
        return torch.as_tensor(local_shard(x, mesh), dtype=torch.float32,
                               device=device)

    def run(u_bases, n: int, extra_weights=None):
        u = local(u_bases)
        ew = None if extra_channel_mats is None else local(extra_weights)
        opt = init_batch_adam(u, conv)
        keep = torch.zeros(u.shape[0], dtype=torch.bool, device=device)
        fids = regs = torch.zeros(u.shape[0], device=device)
        for _ in range(int(n)):
            x = u.detach().requires_grad_(True)
            regs, fids = batched_loss(x, ew)
            (g,) = torch.autograd.grad(regs.sum(), x)
            u, opt = batched_adam_update(u, opt, g, keep, factor)
        return tuple(gather(y.detach(), mesh) for y in (u, fids, regs))

    return run
