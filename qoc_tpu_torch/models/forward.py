"""The forward model: pulse weights -> propagation -> loss + metrics (port
of ``qoc_tpu.models.forward``, iso and complex representations).

``make_forward`` closes over a ``ControlProblem`` whose arrays it moves to
``device`` once, and returns plain torch functions of the pulse
``u_base [K, T]``: the analysis forward (``lean=False``: emits inter_vecs
when ``use_inter_vecs``) and the lean optimization loss (intermediate
states only when a selected cost reads them, ``INTER_VEC_COSTS``).  The
regularized loss is ``loss + total_reg_cost(...)`` (``models.costs``),
enqueued inside the span ``qoc.costs``.

On the unitary ``pscan`` engine the loss reads the final unitary only
through final_vecs, so the full product (``final_state``) is an output
alone: the analysis forward computes it without gradient, and the lean
loss, which nothing reads it from, leaves it out (``final_state`` None),
where qoc_tpu leaves XLA to drop its stop-gradient copy.

``representation="complex"`` propagates native complex64 [N, N] instead
of the real [2N, 2N] isomorphism (qoc_tpu/models/forward.py:211-334):
the same loss, penalties and iso-layout outputs, exact gradients only,
``resolved_engine == "complex"``.  ``"auto"`` resolves to ``"iso"``, as in
qoc_tpu.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..interop import full_fp32_matmul, problem_tensors
from ..ops.expm import taylor_expm, weighted_hamiltonians
from ..ops.inner_products import inner_product_2d
from ..ops.propagation import (
    chain_product_tree,
    evolve_unitary,
    evolve_unitary_pscan,
    evolve_unitary_tree,
    prefix_products,
    state_transfer_chain,
    step_propagators,
)
from ..utils.profiling import span
from .costs import CostContext, total_reg_cost
from .system import ControlProblem

INTER_VEC_COSTS = ("forbidden_coeff_list", "forbidden", "speed_up")


class ForwardOutput(NamedTuple):
    loss: torch.Tensor           # fidelity loss 1 - F
    reg_loss: torch.Tensor       # loss + penalties (the optimization target)
    unitary_scale: torch.Tensor  # unitarity diagnostic (tensorflow_state.py:225,:335)
    # [2N, 2N] final unitary, or [2N, V] final vecs (None: the lean
    # unitary pscan, which never forms the unitary)
    final_state: Optional[torch.Tensor]
    inter_vecs: Optional[torch.Tensor]  # [T+1, 2N, V] or None
    ops_weight: torch.Tensor     # [K, T] normalized weights sin(base)


def make_forward(
    problem: ControlProblem,
    reg_coeffs: Optional[dict] = None,
    gradient_mode: str = "exact",
    engine: str = "auto",
    lean: bool = False,
    device="cpu",
    remat: bool = False,
    representation: str = "auto",
):
    """Build ``forward(u_base) -> ForwardOutput`` and ``loss_fn(u_base) ->
    (reg_loss, ForwardOutput)``; both carry ``.resolved_engine``.
    ``remat`` recomputes propagators in the backward pass (the serial
    state-transfer scan and the unitary step propagators)."""
    p = problem
    device = torch.device(device)
    if representation == "auto":
        representation = "iso"
    if representation == "complex":
        if gradient_mode != "exact":
            raise ValueError(
                "representation='complex' supports only exact gradients; "
                "the reference-parity custom VJPs are iso-layout")
        return _make_forward_complex(p, reg_coeffs, lean, device)
    if representation != "iso":
        raise ValueError(f"unknown representation {representation!r}")
    tens = problem_tensors(p, device)
    mats, U0, psi0 = tens["mats"], tens["U0_iso"], tens["initial_vectors"]
    target_vecs, max_amp = tens["target_vectors"], tens["ops_max_amp"]
    N = p.state_num
    needs_inter = _needs_inter(p, reg_coeffs, lean)
    # imported here: routing reads INTER_VEC_COSTS from this module
    from ..routing import resolve_single_engine

    resolved_engine = resolve_single_engine(p, reg_coeffs, gradient_mode,
                                            engine, lean, device)
    ones = torch.ones((1, p.steps), dtype=torch.float32, device=device)

    def forward(u_base: torch.Tensor,
                mats_in: Optional[torch.Tensor] = None) -> ForwardOutput:
        """``mats_in`` overrides the problem's generators (the batch
        layer's per-seed Hamiltonian sweep)."""
        mats_ = mats if mats_in is None else mats_in
        ops_weight = torch.sin(u_base)   # hard |u| <= maxA bound (tensorflow_state.py:176)
        weights = torch.cat([ones, max_amp[:, None] * ops_weight])  # row 0 = drift
        if p.state_transfer:
            inter_vecs = state_transfer_chain(
                mats_, weights, psi0, p.taylor_terms,
                gradient_mode=gradient_mode, engine=engine,
                final_only=not needs_inter, remat=remat)
            final_vecs = inter_vecs[-1]
            loss = 1.0 - inner_product_2d(final_vecs, target_vecs, N)
            unitary_scale = inner_product_2d(final_vecs, final_vecs, N)
            final_state = final_vecs
            if not needs_inter:
                inter_vecs = None
        else:
            if resolved_engine == "pscan" and gradient_mode == "exact":
                final_vecs, unitary_scale, inter_vecs = evolve_unitary_pscan(
                    mats_, weights, U0, psi0, p.taylor_terms,
                    p.taylor_scaling, use_inter_vecs=needs_inter)
                final_U = None
                if not lean:
                    with torch.no_grad():
                        final_U = torch.matmul(chain_product_tree(
                            step_propagators(mats_, weights, p.taylor_terms,
                                             p.taylor_scaling)), U0)
            else:
                if (resolved_engine == "tree" and not needs_inter
                        and gradient_mode == "exact"):
                    final_U = evolve_unitary_tree(
                        mats_, weights, U0, p.taylor_terms, p.taylor_scaling)
                    inter_vecs = None
                else:
                    final_U, inter_vecs = evolve_unitary(
                        mats_, weights, U0, psi0, p.taylor_terms,
                        p.taylor_scaling, gradient_mode=gradient_mode,
                        engine=resolved_engine, use_inter_vecs=needs_inter,
                        remat=remat)
                final_vecs = torch.matmul(final_U, psi0)
                unitary_scale = (0.5 / N) * torch.sum(
                    torch.matmul(final_U.T, final_U))
            loss = 1.0 - inner_product_2d(final_vecs, target_vecs, N)
            final_state = final_U
        ctx = CostContext(
            ops_weight=ops_weight, inter_vecs=inter_vecs,
            target_vecs=target_vecs, state_num=N, steps=p.steps, dt=p.dt,
            total_time=p.total_time,
            one_minus_gauss=tens["one_minus_gauss"],
            v_sorted_iso=tens.get("v_sorted_iso"))
        with span("qoc.costs"):
            reg_loss = loss + total_reg_cost(ctx, reg_coeffs)
        return ForwardOutput(loss, reg_loss, unitary_scale, final_state,
                             inter_vecs, ops_weight)

    def loss_fn(u_base: torch.Tensor, mats_in: Optional[torch.Tensor] = None):
        out = forward(u_base, mats_in)
        return out.reg_loss, out

    forward.resolved_engine = resolved_engine
    loss_fn.resolved_engine = resolved_engine
    return forward, loss_fn


def _needs_inter(p, reg_coeffs, lean: bool) -> bool:
    if lean:
        return p.use_inter_vecs and any(
            k in (reg_coeffs or {}) for k in INTER_VEC_COSTS)
    return p.use_inter_vecs


def _make_forward_complex(p, reg_coeffs, lean: bool, device):
    """Native complex64 forward: the same math on [N, N] complex
    propagators, converted to the iso layout at the boundary so that the
    costs and every output are unchanged."""
    if device.type == "cuda":
        full_fp32_matmul()

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x).astype(dtype), device=device)

    mats_c = dev(p.mats_c, np.complex64)
    U0_c = dev(p.U0_c, np.complex64)
    psi0_c = dev(p.initial_vectors_c.T, np.complex64)
    tens = problem_tensors(p, device)
    tv_iso, max_amp = tens["target_vectors"], tens["ops_max_amp"]
    N = p.state_num
    V = psi0_c.shape[1]
    target_c = torch.complex(tv_iso[:N], tv_iso[N:])
    needs_inter = _needs_inter(p, reg_coeffs, lean)
    if p.state_transfer:
        order, scaling = p.taylor_terms - 1, 0
    else:
        order, scaling = p.taylor_terms, p.taylor_scaling
    ones = torch.ones((1, p.steps), dtype=torch.float32, device=device)

    def vecs_to_iso(vc):
        return torch.cat([vc.real, vc.imag], dim=-2)

    def mat_to_iso(Mc):
        re, im = Mc.real, Mc.imag
        return torch.cat([torch.cat([re, -im], dim=-1),
                          torch.cat([im, re], dim=-1)], dim=-2)

    def overlap_sq(a, b):
        ov = torch.sum(torch.conj(a) * b)
        return (ov.real ** 2 + ov.imag ** 2) / (V * V)

    def forward(u_base: torch.Tensor,
                mats_in: Optional[torch.Tensor] = None) -> ForwardOutput:
        mats_ = mats_c if mats_in is None else mats_in
        ops_weight = torch.sin(u_base)
        weights = torch.cat([ones, max_amp[:, None] * ops_weight])
        A = weighted_hamiltonians(mats_, weights.to(torch.complex64))
        P = taylor_expm(A, order, scaling)                  # [T, N, N]
        if needs_inter:
            cumU = torch.matmul(prefix_products(P), U0_c)
            final_U = cumU[-1]
            inter_c = torch.cat([torch.matmul(U0_c, psi0_c)[None],
                                 torch.matmul(cumU, psi0_c)])
            inter_vecs = vecs_to_iso(inter_c)
        else:
            final_U = torch.matmul(chain_product_tree(P), U0_c)
            inter_vecs = None
        final_c = torch.matmul(final_U, psi0_c)
        # 1 - |sum_v <t_v|psi_v>|^2 / V^2 (coherent, = inner_product_2d)
        loss = 1.0 - overlap_sq(target_c, final_c)
        if p.state_transfer:
            final_state = vecs_to_iso(final_c)
            unitary_scale = overlap_sq(final_c, final_c)
        else:
            F = mat_to_iso(final_U)
            final_state = F
            unitary_scale = (0.5 / N) * torch.sum(torch.matmul(F.T, F))
        ctx = CostContext(
            ops_weight=ops_weight, inter_vecs=inter_vecs,
            target_vecs=tv_iso, state_num=N, steps=p.steps, dt=p.dt,
            total_time=p.total_time,
            one_minus_gauss=tens["one_minus_gauss"],
            v_sorted_iso=tens.get("v_sorted_iso"))
        with span("qoc.costs"):
            reg_loss = loss + total_reg_cost(ctx, reg_coeffs)
        return ForwardOutput(loss, reg_loss, unitary_scale, final_state,
                             inter_vecs, ops_weight)

    def loss_fn(u_base: torch.Tensor, mats_in: Optional[torch.Tensor] = None):
        out = forward(u_base, mats_in)
        return out.reg_loss, out

    forward.resolved_engine = "complex"
    loss_fn.resolved_engine = "complex"
    return forward, loss_fn
