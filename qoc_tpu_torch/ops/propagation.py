"""Time propagation engines (port of ``qoc_tpu.ops.propagation``).

Engines, with qoc_tpu's names and auto ladders (``resolve_state_engine``,
``resolve_unitary_engine``, ``pick_engine``):

  * ``tree``: the fused chain product (``ops.tree_chain``), the CUDA
    kernels on the card; final state / unitary only.
  * ``pscan``: all step propagators as one batched Taylor series, then a
    serial [M, M] @ [M, V] state sweep, with the matvec-adjoint backward
    (``pscan_chain``): no M^3 work in the gradient.  On the card each
    sweep is one launch of ``csrc/pscan_sweep.cu`` (``pscan_sweep``,
    ``pscan_reverse_sweep``), elsewhere a loop of products.
  * ``associative``: the batched step propagators and their prefix
    products (``prefix_products``, lax.associative_scan's recursion),
    autograd through both.
  * ``scan``: the serial chain, a Python loop of small products; every
    run on the CPU takes it where the ladders say so, as in qoc_tpu.

The batched Taylor step (``batched_taylor_expm``: pscan's Q, the
associative engine's and the unitary chains' step propagators) goes
through kernels 7-8 (``ops.fused_expm``) on a CUDA tensor wherever
``fused_expm_supported`` admits the shape, and through the plain
``taylor_expm`` otherwise, which computes the same function.  qoc_tpu's
128-lane pad around pscan (a TPU layout trick) stays out.

Gradient modes, as in qoc_tpu: ``exact`` differentiates the truncated
series; ``reference`` replaces each step's derivative with the
reference's first-order GRAPE gradient (tensorflow_state.py:49-142):
``step_propagators_ref_grad`` for the unitary chains and
``matvec_step_ref`` for the state-transfer scan, new-style
``autograd.Function``s whose vmap rule is generated, so they also run
under the batch layer's ``torch.func`` backend.  ``remat`` recomputes the
step propagators (unitary) or the steps (the state-transfer scan) in the
backward pass with ``ops.remat.recompute``, which also runs under
``torch.func``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..utils.profiling import spanned
from . import _cuda
from .expm import taylor_expm, taylor_expm_matvec, weighted_hamiltonians
from .fused_expm import fused_expm_supported, fused_taylor_expm
from .remat import recompute
from .tree_chain import fused_tree_chain, tree_chain_supported


def batched_taylor_expm(A: torch.Tensor, order: int,
                        scaling: int) -> torch.Tensor:
    """``taylor_expm`` of A [T, M, M]: kernels 7-8 on a CUDA tensor that
    ``fused_expm_supported`` admits, else the plain series (the shapes
    qoc_tpu's kernel does not take either)."""
    if (A.device.type == "cuda" and A.dim() == 3
            and fused_expm_supported(A.shape[-1], order, scaling)):
        return fused_taylor_expm(A, order, scaling)
    return taylor_expm(A, order, scaling)


def step_propagators(mats, weights, order: int, scaling: int):
    """All per-step propagators exp(sum_k w[k,t] mats[k]): [K,M,M], [K,T] -> [T,M,M]."""
    return batched_taylor_expm(weighted_hamiltonians(mats, weights), order,
                               scaling)


def _zero_drift_row(wbar: torch.Tensor) -> torch.Tensor:
    """The drift weight gets no gradient (tensorflow_state.py:54)."""
    return torch.cat([torch.zeros_like(wbar[:1]), wbar[1:]])


class _StepPropagatorsRefGrad(torch.autograd.Function):
    """``qoc_tpu.step_propagators_ref_grad``: the forward is
    ``step_propagators``; the backward is matexp_op_grad
    (tensorflow_state.py:49-65), wbar[k, t] = sum_ij Gbar[t] * (mats[k] @
    P[t]) for k >= 1, zero for the drift row and for ``mats``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(mats, weights, order, scaling):
        return step_propagators(mats, weights, order, scaling)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, G):
        mats, P = ctx.saved_tensors
        X = torch.einsum("tim,tjm->tij", G, P)
        wbar = torch.einsum("kij,tij->kt", mats, X)
        return torch.zeros_like(mats), _zero_drift_row(wbar), None, None


def step_propagators_ref_grad(mats, weights, order: int, scaling: int):
    """All step propagators [T, M, M] with the reference's gradient."""
    return _StepPropagatorsRefGrad.apply(mats, weights, order, scaling)


class _MatvecStepRef(torch.autograd.Function):
    """``qoc_tpu._matvec_step_ref``: one state-transfer step psi' =
    exp(A_t) psi (Taylor powers 0..order-1), with matvecexp_op_grad
    (tensorflow_state.py:100-133) as its backward: wbar[k] = sum(Gbar *
    (mats[k] @ psi')) for k >= 1, zero for the drift and for ``mats``, and
    the cotangent evolved back with exp(-A_t) at the same order."""

    generate_vmap_rule = True

    @staticmethod
    def forward(mats, w_t, psi, order):
        A = torch.einsum("k,kij->ij", w_t, mats)
        return taylor_expm_matvec(A, psi, order)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mats, w_t, _, order = inputs
        ctx.save_for_backward(mats, w_t, output)
        ctx.order = order

    @staticmethod
    def backward(ctx, G):
        mats, w_t, out = ctx.saved_tensors
        Hk_out = torch.einsum("kij,jv->kiv", mats, out)
        wbar = _zero_drift_row(torch.einsum("kiv,iv->k", Hk_out, G))
        A_neg = torch.einsum("k,kij->ij", -w_t, mats)
        psibar = taylor_expm_matvec(A_neg, G, ctx.order)
        return torch.zeros_like(mats), wbar, psibar, None


def matvec_step_ref(mats, w_t, psi, order: int):
    """One state-transfer step with the reference's gradient."""
    return _MatvecStepRef.apply(mats, w_t, psi, order)


# ---------------------------------------------------------------------------
# Unitary-mode chains
# ---------------------------------------------------------------------------


def prefix_products(P: torch.Tensor) -> torch.Tensor:
    """cum[t] = P[t] @ ... @ P[0] for P [T, M, M], the later factor on the
    left: lax.associative_scan's recursion (pairs, recurse on the pair
    products, fill in the even entries), O(T) products in O(log T)
    depth."""
    n = P.shape[0]
    if n < 2:
        return P
    odd = prefix_products(torch.matmul(P[1::2], P[0:n - 1:2]))
    even = torch.matmul(P[2::2], odd[:-1] if n % 2 == 0 else odd)
    even = torch.cat([P[:1], even])
    pairs = torch.stack([even[:odd.shape[0]], odd], dim=1).flatten(0, 1)
    return torch.cat([pairs, even[odd.shape[0]:]])


def chain_associative(P, U0, psi0):
    """Cumulative products by the parallel prefix: (final_U [M, M],
    inter_vecs [T+1, M, V]) with inter_states[t] = P_t ... P_0 U0
    (tensorflow_state.py:214-220); entry 0 is the raw psi0."""
    cumU = torch.matmul(prefix_products(P), U0)
    vecs = torch.matmul(cumU, psi0)
    return cumU[-1], torch.cat([psi0[None], vecs])


def chain_scan(P, U0, psi0):
    """Serial chain carrying (U, psi).  Returns (final_U [M,M], inter_vecs
    [T+1, M, V]); entry 0 is the RAW psi0 and the vector chain starts from
    U0 @ psi0 (tensorflow_state.py:211-214, 233-238)."""
    U = U0
    psi = torch.matmul(U0, psi0)
    vecs = [psi0]
    for t in range(P.shape[0]):
        U = torch.matmul(P[t], U)
        psi = torch.matmul(P[t], psi)
        vecs.append(psi)
    return U, torch.stack(vecs)


def chain_scan_novecs(P, U0):
    """Serial chain without intermediate vectors."""
    U = U0
    for t in range(P.shape[0]):
        U = torch.matmul(P[t], U)
    return U


def chain_product_tree(P):
    """P[T-1] @ ... @ P[0] by pairwise reduction (an odd tail rides up)."""
    while P.shape[0] > 1:
        T = P.shape[0]
        half = T // 2
        prod = torch.matmul(P[1: 2 * half: 2], P[0: 2 * half: 2])
        if T % 2 == 1:
            prod = torch.cat([prod, P[T - 1:]], dim=0)
        P = prod
    return P[0]


# ---------------------------------------------------------------------------
# Engine ladders (qoc_tpu/ops/propagation.py:179-211, 633-641; the
# thresholds are qoc_tpu's, kept so that both packages route alike)
# ---------------------------------------------------------------------------


def pick_engine(dim_real: int, steps: int) -> str:
    """The unitary fallback rung: the associative engine while its ~3 T
    copies of [M, M] stay under 1 GiB of float32, else the serial scan."""
    bytes_needed = 4 * steps * dim_real * dim_real * 3
    return "associative" if bytes_needed < (1 << 30) else "scan"


def resolve_state_engine(M: int, T: int, gradient_mode: str,
                         final_only: bool, on_accel: bool) -> str:
    """State-transfer ladder: tree (fused, small, final-only) -> pscan
    (M >= 16) -> associative (tiny M with trajectory) -> scan (CPU and
    beyond)."""
    if gradient_mode == "exact" and on_accel:
        if final_only and tree_chain_supported(M, T):
            return "tree"
        if M >= 16 and 8 * T * M * M < (1 << 31):
            return "pscan"
        if 4 * T * M * M * 3 < (1 << 30):
            return "associative"
    return "scan"


def resolve_unitary_engine(M: int, T: int, scaling: int, gradient_mode: str,
                           needs_inter: bool, on_accel: bool) -> str:
    """Unitary ladder: tree (final-only) -> pscan (rank-V adjoint through
    the squaring expansion, M >= 16) -> ``pick_engine``."""
    if gradient_mode == "exact" and on_accel:
        if not needs_inter and tree_chain_supported(M, T):
            return "tree"
        reps = 1 << scaling
        if M >= 16 and 8 * T * reps * M * M < (1 << 31):
            return "pscan"
    return pick_engine(M, T)


# ---------------------------------------------------------------------------
# The pscan engine
# ---------------------------------------------------------------------------


def _pscan_run(mats, weights, psi0, order: int, reps: int):
    """Q_t = Taylor_{0..order-1}(A_t / reps) batched, then the serial sweep
    applying each Q_t ``reps`` times.  Returns (vecs [T*reps+1, M, V], A,
    Q)."""
    A = weighted_hamiltonians(mats, weights)
    if reps > 1:
        A = A / reps              # exp(A) = Q^reps, Q = Taylor(A / reps)
    Q = batched_taylor_expm(A, order - 1, 0)
    return pscan_sweep(Q, psi0, reps), A, Q


def pscan_sweep_plain(Q, psi0, reps: int):
    """The forward sweep as a loop of products (the CPU's, and the
    reference the card's tests hold the kernel to): psi <- Q_t psi,
    ``reps`` times a step, from psi0 [..., M, V]; the sub-step trajectory
    [..., T*reps + 1, M, V].  Leading dimensions of Q [..., T, M, M] and
    psi0 are seeds."""
    psi = psi0
    vecs = [psi0]
    for Qt in Q.unbind(-3):
        for _ in range(reps):
            psi = torch.matmul(Qt, psi)
            vecs.append(psi)
    return torch.stack(vecs, dim=-3)


def pscan_reverse_plain(Q, g, reps: int):
    """The adjoint sweep as a loop of products, over sub-steps i =
    T*reps-1 .. 0: lam_i = mu + g_{i+1} (the full cotangent of the state
    after sub-step i), then mu = Q_t^T lam_i.  g [..., T*reps + 1, M, V]
    -> (lams [..., T, reps, M, V], psi0_bar)."""
    T = Q.shape[-3]
    gsub = g[..., 1:, :, :]
    QT = Q.mT.unbind(-3)
    mu = torch.zeros_like(g[..., 0, :, :])
    lams = [None] * (T * reps)
    for i in range(T * reps - 1, -1, -1):
        lam = mu + gsub[..., i, :, :]
        lams[i] = lam
        mu = torch.matmul(QT[i // reps], lam)
    return (torch.stack(lams, dim=-3).reshape(*g.shape[:-3], T, reps,
                                              *g.shape[-2:]),
            mu + g[..., 0, :, :])


def _on_card(x: torch.Tensor) -> bool:
    """A sweep on a CUDA tensor is the kernel's, whatever its shape: one it
    cannot take (not float32) raises there, and never runs the loop."""
    return x.device.type == "cuda"


def _seeds_first(x: torch.Tensor, bdim):
    return x if bdim is None else x.movedim(bdim, 0)


def _every_seed(x: torch.Tensor, batched: bool, seeds: int, dims: int):
    """x with the seeds dimension in front (a view of the shared one)."""
    return x if batched else x.expand(seeds, *x.shape[-dims:])


class _PscanSweep(torch.autograd.Function):
    """The forward sweep: ``_cuda.pscan_forward`` on a CUDA tensor,
    ``pscan_sweep_plain`` elsewhere.  Its vmap rule makes a vmapped batch
    one launch, the seeds the grid."""

    @staticmethod
    def forward(Q, psi0, reps):
        if _on_card(Q):
            return _cuda.pscan_forward(Q, psi0, reps)[0]
        return pscan_sweep_plain(Q, psi0, reps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the pscan sweeps are differentiated by _PscanChain's adjoint")

    @staticmethod
    def vmap(info, in_dims, Q, psi0, reps):
        B = info.batch_size
        Q, psi0 = _seeds_first(Q, in_dims[0]), _seeds_first(psi0, in_dims[1])
        if _on_card(Q):
            return _cuda.pscan_forward(Q, psi0, reps, B), 0
        return pscan_sweep_plain(
            _every_seed(Q, in_dims[0] is not None, B, 3),
            _every_seed(psi0, in_dims[1] is not None, B, 2), reps), 0


class _PscanReverse(torch.autograd.Function):
    """The adjoint sweep: ``_cuda.pscan_reverse`` on a CUDA tensor,
    ``pscan_reverse_plain`` elsewhere; vmap as ``_PscanSweep``."""

    @staticmethod
    def forward(Q, g, reps):
        if _on_card(Q):
            lams, psi0_bar = _cuda.pscan_reverse(Q, g, reps)
            return lams[0].reshape(Q.shape[0], reps, *g.shape[1:]), psi0_bar[0]
        return pscan_reverse_plain(Q, g, reps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, lams_bar, psi0_bar_bar):
        raise NotImplementedError(
            "the pscan sweeps are differentiated by _PscanChain's adjoint")

    @staticmethod
    def vmap(info, in_dims, Q, g, reps):
        B = info.batch_size
        Q, g = _seeds_first(Q, in_dims[0]), _seeds_first(g, in_dims[1])
        if _on_card(Q):
            lams, psi0_bar = _cuda.pscan_reverse(Q, g, reps, B)
            T = Q.shape[-3]
            return (lams.reshape(B, T, reps, *g.shape[-2:]), psi0_bar), (0, 0)
        return pscan_reverse_plain(
            _every_seed(Q, in_dims[0] is not None, B, 3),
            _every_seed(g, in_dims[1] is not None, B, 3), reps), (0, 0)


@spanned("qoc.pscan.sweep")
def pscan_sweep(Q, psi0, reps: int):
    """The forward sweep: psi <- Q_t psi, ``reps`` times per step, from
    psi0 [M, V]; the sub-step trajectory [T*reps + 1, M, V].  One kernel
    launch on the card (``csrc/pscan_sweep.cu``), the plain loop
    elsewhere; under ``torch.func.vmap`` one launch for every seed."""
    return _PscanSweep.apply(Q, psi0, reps)


@spanned("qoc.pscan.reverse")
def pscan_reverse_sweep(Q, g, reps: int):
    """The adjoint sweep over sub-steps i = T*reps-1 .. 0: lam_i = mu + g_i
    (the full cotangent of the state after sub-step i), then mu = Q_t^T
    lam_i.  g [T*reps + 1, M, V] -> (lams [T, reps, M, V], psi0_bar); one
    launch on the card, as ``pscan_sweep``."""
    return _PscanReverse.apply(Q, g, reps)


def _coefficients(q: int, like: torch.Tensor) -> torch.Tensor:
    """C[j, l] = 1 / (j + l + 1)! where j + l + 1 <= q, else 0."""
    fact = np.ones(2 * q, dtype=np.float64)
    for n in range(1, 2 * q):
        fact[n] = fact[n - 1] * n
    C = np.zeros((q, q), dtype=np.float32)
    for j in range(q):
        for l in range(q):
            if j + l + 1 <= q:
                C[j, l] = 1.0 / fact[j + l + 1]
    return torch.as_tensor(C, dtype=like.dtype, device=like.device)


def pscan_pairing(mats, weights, A, vecs, lams, q: int, reps: int):
    """The batched part of the adjoint: power ladders f_l = A^l psi_prev
    and b_j = (A^T)^j lam over every sub-step, the pairing Abar_t =
    sum_r sum_{j+l+1 <= q} b_j f_l^T / (j+l+1)!, then (matsbar, wbar)."""
    T, M, V = A.shape[0], vecs.shape[1], vecs.shape[2]
    pre = vecs[:-1].reshape(T, reps, M, V)   # states before each sub-step

    def ladder(A_, x0):               # [T, reps, M, V] -> [T, reps, q, M, V]
        xs = [x0]
        for _ in range(1, q):
            xs.append(torch.matmul(A_[:, None], xs[-1]))
        return torch.stack(xs, dim=2)

    F = ladder(A, pre)                # f_l = A^l psi_prev
    B = ladder(A.mT, lams)            # b_j = (A^T)^j lam
    CF = torch.einsum("jl,trlnv->trjnv", _coefficients(q, A), F)
    Abar = torch.einsum("trjmv,trjnv->tmn", B, CF)
    inv = 1.0 / reps                  # dA_scaled/dw = mats / reps
    wbar = inv * torch.einsum("kmn,tmn->kt", mats, Abar)
    matsbar = inv * torch.einsum("kt,tmn->kmn", weights, Abar)
    return matsbar, wbar


class _PscanChain(torch.autograd.Function):
    """``qoc_tpu._pscan_chain_core``: the forward sweep, and the matvec
    adjoint as its backward.

    The trajectory cotangent against a product chain is rank V per step,
    so the exact gradient of the truncated series needs no M^3 work: the
    reverse sweep lam_{i-1} = Q^T lam_i + g_{i-1} (T*reps serial
    transposed mat-vecs, ``pscan_reverse_sweep``), then the batched power
    ladders and their pairing (``pscan_pairing``); wbar = <mats_k,
    Abar_t> / reps and matsbar = sum_t w_kt Abar_t / reps.

    A new-style Function, so that it runs under ``torch.func`` (the batch
    layer's vmapped backend): the forward returns the intermediates A and
    Q beside the trajectory, marked non-differentiable, for the backward
    to reuse (recomputing them would cost a second batched Taylor series),
    and the vmap rule is generated: forward and backward are torch ops,
    ``fused_taylor_expm``, whose own rule folds the vmapped seeds into
    the timesteps, so one batched series serves every seed, and the two
    sweeps, whose rules make every seed one launch."""

    generate_vmap_rule = True

    @staticmethod
    def forward(mats, weights, psi0, order, reps):
        return _pscan_run(mats, weights, psi0, order, reps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mats, weights, _, order, reps = inputs
        vecs, A, Q = output
        ctx.mark_non_differentiable(A, Q)
        ctx.save_for_backward(mats, weights, A, Q, vecs)
        ctx.order, ctx.reps = order, reps

    @staticmethod
    def backward(ctx, g, _A_bar, _Q_bar):
        mats, weights, A, Q, vecs = ctx.saved_tensors
        q = ctx.order - 1                 # highest power kept in Q
        lams, psi0_bar = pscan_reverse_sweep(Q, g, ctx.reps)
        if q < 1:
            return (torch.zeros_like(mats), torch.zeros_like(weights),
                    psi0_bar, None, None)
        matsbar, wbar = pscan_pairing(mats, weights, A, vecs, lams, q,
                                      ctx.reps)
        return matsbar, wbar, psi0_bar, None, None


def pscan_chain(mats, weights, psi0, order: int, reps: int = 1):
    """Batched-propagator state chain with the matvec-adjoint backward:
    mats [K, M, M], weights [K, T], psi0 [M, V] -> the sub-step trajectory
    [T*reps + 1, M, V] (``reps = 2**scaling`` expands the squaring chain
    into repeated sub-steps; state transfer has reps = 1).
    Differentiable in mats, weights and psi0, and under ``torch.func``
    transforms."""
    return _PscanChain.apply(mats, weights, psi0, order, reps)[0]


def evolve_unitary_pscan(mats, weights, U0, psi0, order: int, scaling: int,
                         use_inter_vecs: bool):
    """Unitary-mode forward through the state-column pscan chain.

    The loss reads the final unitary only through final_vecs = U_total
    psi0, so the gradient rides the matvec adjoint with 2^s sub-steps per
    step; unitary_scale = 0.5/N sum(F^T F) = 0.5/N ||F 1||^2 comes from
    one extra propagated ones-column.  Returns (final_vecs [M, V],
    unitary_scale, inter_vecs or None)."""
    reps = 1 << scaling
    M, V = psi0.shape
    s0 = torch.matmul(U0, psi0)
    ones_col = torch.matmul(U0, torch.ones((M, 1), dtype=psi0.dtype,
                                           device=psi0.device))
    vecs_all = pscan_chain(mats, weights, torch.cat([s0, ones_col], dim=1),
                           order + 1, reps)
    final = vecs_all[-1]
    unitary_scale = (0.5 / (M // 2)) * torch.sum(torch.square(final[:, V]))
    inter_vecs = None
    if use_inter_vecs:
        # entry 0 is the RAW packed psi0 (tensorflow_state.py:229-242);
        # entries >= 1 include U0
        inter_vecs = torch.cat([psi0[None], vecs_all[reps::reps, :, :V]])
    return final[:, :V], unitary_scale, inter_vecs


# ---------------------------------------------------------------------------
# State transfer and the unitary forward
# ---------------------------------------------------------------------------


def state_transfer_chain(mats, weights, psi0, order: int,
                         gradient_mode: str = "exact", engine: str = "auto",
                         final_only: bool = False, remat: bool = False):
    """Evolve stacked state vectors psi0 [M, V] through all steps.

    Returns inter_vecs [T+1, M, V], or [1, M, V] (the final state) with
    ``final_only``.  Taylor convention of state transfer: powers
    0..order-1, no squaring.  The tree, associative and pscan engines take
    exact gradients only; the reference gradient and ``remat`` run the
    serial scan, as in qoc_tpu.  With ``remat`` the final-only scan keeps
    one state per chunk of about sqrt(T) steps and recomputes the chunk in
    the backward pass; otherwise each step is recomputed.
    """
    exact = gradient_mode == "exact"
    if engine == "auto":
        engine = resolve_state_engine(mats.shape[-1], weights.shape[-1],
                                      gradient_mode, final_only,
                                      weights.device.type == "cuda")

    if exact and engine == "tree" and final_only:
        E = fused_tree_chain(mats, weights, order - 1, 0)
        return torch.matmul(E, psi0)[None]

    if exact and engine == "associative":
        P = step_propagators(mats, weights, order - 1, 0)
        if final_only:
            return torch.matmul(chain_product_tree(P), psi0)[None]
        vecs = torch.matmul(prefix_products(P), psi0)
        return torch.cat([psi0[None], vecs])

    if exact and engine == "pscan":
        vecs = pscan_chain(mats, weights, psi0, order, 1)
        return vecs[-1][None] if final_only else vecs

    T = weights.shape[-1]
    if not exact:
        def step(psi, mats, weights, t):
            return matvec_step_ref(mats, weights[:, t], psi, order)
    elif remat:
        # the generator is formed inside the recompute
        def step(psi, mats, weights, t):
            return taylor_expm_matvec(
                torch.einsum("k,kij->ij", weights[:, t], mats), psi, order)
    else:
        A = weighted_hamiltonians(mats, weights)

        def step(psi, mats, weights, t):
            return taylor_expm_matvec(A[t], psi, order)

    def run(psi, mats, weights, t0: int, t1: int):
        for t in range(t0, t1):
            psi = step(psi, mats, weights, t)
        return psi

    if final_only:
        # remat keeps one state per chunk of ~sqrt(T) steps: two levels,
        # tensorflow_state.py:58's recompute-in-backward generalized
        chunk = max(int(T ** 0.5), 1) if remat else max(T, 1)
    else:
        chunk = 1
    psi = psi0
    vecs = [psi0]
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        psi = (recompute(partial(run, t0=t0, t1=t1), psi, mats, weights)
               if remat else run(psi, mats, weights, t0, t1))
        vecs.append(psi)
    return psi[None] if final_only else torch.stack(vecs)


def evolve_unitary(mats, weights, U0, psi0, order: int, scaling: int,
                   gradient_mode: str = "exact", engine: str = "associative",
                   use_inter_vecs: bool = True, remat: bool = False):
    """Unitary-mode forward: (final_U, inter_vecs or None).  The
    reference gradient replaces the step propagators' derivative;
    ``remat`` recomputes them in the backward pass (exact mode)."""
    if gradient_mode == "reference":
        P = step_propagators_ref_grad(mats, weights, order, scaling)
    elif remat:
        P = recompute(partial(step_propagators, order=order,
                              scaling=scaling), mats, weights)
    else:
        P = step_propagators(mats, weights, order, scaling)
    if not use_inter_vecs:
        if engine == "scan":
            return chain_scan_novecs(P, U0), None
        return torch.matmul(chain_product_tree(P), U0), None
    if engine == "associative":
        return chain_associative(P, U0, psi0)
    return chain_scan(P, U0, psi0)


def evolve_unitary_tree(mats, weights, U0, order: int, scaling: int):
    """Final unitary through the fused tree chain (final-only path)."""
    return torch.matmul(fused_tree_chain(mats, weights, order, scaling), U0)
