"""Fused Adam segments: n full GRAPE iterations per launch (port of
``qoc_tpu.ops.pallas_mega``, fidelity-only objective).

On the card, ``run_segment`` launches the hand-written CUDA kernel of
``csrc/mega.cu``: sin-bounded weights, Taylor steps, the pairwise tree
chain, the coherent fidelity and ``unitary_scale``, the exact backward,
Adam with bias correction and exponential LR decay, the convergence test
and the freeze, for n iterations in one launch.  ``mega_segment_reference``
is the plain torch version: the same forward, autograd for the gradient,
and the kernel's own Adam, bias-correction and freeze arithmetic.  The
runner uses the plain version for a problem held on the CPU only.

Semantics (``qoc_tpu.ops.pallas_mega``, ``optim/adam.py``): metrics are
evaluated at the current iterate; ``loss < conv_target | grad^2 <
min_grad | iteration >= max_iterations`` then freezes u, m, v, the LR and
the count; the metrics a segment returns belong to the last evaluated
iterate and start as inf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..interop import adam_state_from_numpy, problem_tensors
from ..optim.adam import B1, B2, EPS, AdamState
from . import _cuda
from .tree_chain import next_pow2, tree_chain_reference, tree_chain_supported


def mega_supported(problem, reg_coeffs=None, gradient_mode="exact") -> bool:
    """The fused segment covers the fidelity-only objective (the penalty
    and trajectory branches come with the costs port) with exact
    gradients, V <= 16 concerned vectors and tree-supported sizes."""
    V = problem.initial_vectors.shape[1]
    return (not reg_coeffs and gradient_mode == "exact"
            and V <= _cuda.MAX_V
            and tree_chain_supported(2 * problem.state_num, problem.steps))


def segment_inputs(problem, device):
    """(mats, psi0p, target, maxamp, u0rows, order, scaling) as the kernel
    takes them; unitary mode folds U0 into psi0p = U0_iso @ psi0 and
    u0rows = U0_iso @ 1 (host numpy, as qoc_tpu builds them)."""
    p = problem
    M = 2 * p.state_num
    tens = problem_tensors(p, device)
    if p.state_transfer:
        order, scaling = p.taylor_terms - 1, 0
        psi0p = np.asarray(p.initial_vectors, dtype=np.float32)
        u0rows = np.zeros((M, 1), dtype=np.float32)
    else:
        order, scaling = p.taylor_terms, p.taylor_scaling
        psi0p = np.asarray(p.U0_iso @ p.initial_vectors, dtype=np.float32)
        u0rows = np.asarray(p.U0_iso @ np.ones((M, 1)), dtype=np.float32)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return (tens["mats"], dev(psi0p), tens["target_vectors"],
            tens["ops_max_amp"], dev(u0rows.reshape(M)), order, scaling)


def mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                           state: AdamState, n: int, *, N: int, T: int,
                           order: int, scaling: int, unitary_mode: bool,
                           rate_factor: float, conv_target: float,
                           min_grad: float, max_iterations: float
                           ) -> AdamState:
    """Plain torch segment: ``n`` iterations of the kernel's arithmetic,
    with autograd for the gradient and float32 scalars throughout.
    Operands as ``_cuda.mega_segment`` takes them (u0rows [M])."""
    f32 = dict(dtype=torch.float32, device=mats.device)
    Tp = state.u_base.shape[1]
    V = psi0p.shape[1]
    live = (torch.arange(Tp, device=mats.device) < T).to(torch.float32)
    ta, tb = target[:N], target[N:]
    log_b1 = torch.tensor(math.log(B1), **f32)
    log_b2 = torch.tensor(math.log(B2), **f32)
    u, m, v = state.u_base, state.m, state.v
    lr = torch.tensor(state.lr, **f32)
    itc = torch.tensor(float(state.iteration), **f32)
    done = bool(state.done)
    loss = g2 = torch.tensor(float("inf"), **f32)
    uscale = torch.tensor(0.0, **f32)
    for _ in range(n):
        uu = u.detach().requires_grad_(True)
        w = torch.cat([live[None], maxamp[:, None] * (torch.sin(uu) * live)])
        E = tree_chain_reference(mats, w, order, scaling)
        final = torch.matmul(E, psi0p)
        fa, fb = final[:N], final[N:]
        re = torch.sum(fa * ta) + torch.sum(fb * tb)
        im = torch.sum(fb * ta) - torch.sum(fa * tb)
        loss_t = 1.0 - (re * re + im * im) / (V * V)
        (g,) = torch.autograd.grad(loss_t, uu)
        with torch.no_grad():
            loss = loss_t.detach()
            if unitary_mode:
                uscale = (0.5 / N) * torch.sum(torch.matmul(E, u0rows) ** 2)
            else:
                uscale = (torch.sum(fa * fa) + torch.sum(fb * fb)) ** 2 / (
                    V * V)
            g2 = 0.5 * torch.sum(g * g)
            done = done or bool(loss < conv_target or g2 < min_grad
                                or itc >= max_iterations)
            do = 0.0 if done else 1.0
            cnt = itc + 1.0
            bc1 = 1.0 - torch.exp(cnt * log_b1)
            bc2 = 1.0 - torch.exp(cnt * log_b2)
            m_n = B1 * m + (1.0 - B1) * g
            v_n = B2 * v + (1.0 - B2) * (g * g)
            u_n = u - lr * ((m_n / bc1) / (torch.sqrt(v_n / bc2) + EPS))
            u = u + do * (u_n - u)
            m = m + do * (m_n - m)
            v = v + do * (v_n - v)
            lr = lr * (1.0 if done else rate_factor)
            itc = itc + do
        if done:   # later iterations would recompute the frozen metrics
            break
    return AdamState(
        u_base=u.detach(), m=m, v=v, lr=float(lr), iteration=int(itc),
        loss=float(loss), reg_loss=float(loss), grad_squared=float(g2),
        unitary_scale=float(uscale), done=done,
    )


def segment_statics(problem, conv, throughput: bool = False) -> dict:
    """The segment's scalar settings (keyword arguments of
    ``mega_segment_reference`` and ``_cuda.mega_segment``); order and
    scaling come from ``segment_inputs``.  ``throughput`` disables the
    convergence test."""
    p = problem
    if throughput:
        conv_target, min_grad, max_iterations = -1.0, -1.0, float(2 ** 30)
    else:
        conv_target = float(conv.conv_target)
        min_grad = float(conv.min_grad)
        max_iterations = float(conv.max_iterations)
    return dict(
        N=p.state_num, T=p.steps, unitary_mode=not p.state_transfer,
        rate_factor=float(np.exp(-1.0 / float(conv.learning_rate_decay))),
        conv_target=conv_target, min_grad=min_grad,
        max_iterations=max_iterations)


def make_mega_segment_runner(problem, conv, throughput: bool = False,
                             reg_coeffs=None, device="cpu"):
    """(init_state, run_segment, unpad) for the fused segment.

    ``run_segment(state, n)`` advances up to ``n`` iterations with the
    convergence semantics of ``optim.adam``; ``throughput=True`` disables
    the convergence test (fixed-count timing).  On a CUDA ``device`` each
    segment is one launch of the CUDA kernel; on the CPU it runs
    ``mega_segment_reference``.
    """
    if reg_coeffs:
        raise NotImplementedError(
            "the fused segment is fidelity-only until the costs port "
            "(ROADMAP.md, Queue 1): reg_coeffs are not supported yet")
    p = problem
    device = torch.device(device)
    T = p.steps
    Tp = next_pow2(max(T, 2))
    mats, psi0p, target, maxamp, u0rows, order, scaling = segment_inputs(
        p, device)
    statics = dict(segment_statics(p, conv, throughput), order=order,
                   scaling=scaling)
    scratch = []

    def init_state(u_base) -> AdamState:
        zeros = np.zeros(np.shape(u_base), dtype=np.float32)
        return adam_state_from_numpy(u_base, zeros, zeros, 0, conv.rate, T,
                                     Tp, device)

    def run_segment(state: AdamState, n: int) -> AdamState:
        if device.type == "cpu":
            return mega_segment_reference(mats, psi0p, target, maxamp,
                                          u0rows, state, int(n), **statics)
        if not scratch:
            scratch.extend(_cuda.mega_scratch(mats.shape[0], mats.shape[1],
                                              Tp, order, scaling, device))
        u = state.u_base.clone()
        m = state.m.clone()
        v = state.v.clone()
        sf = torch.tensor([state.lr, float(state.iteration),
                           float(state.done)], dtype=torch.float32,
                          device=device)
        met = _cuda.mega_segment(
            mats, psi0p, target, maxamp, u0rows, u, m, v, sf,
            n_iters=int(n), b1=B1, b2=B2, eps=EPS, scratch=tuple(scratch),
            **statics).tolist()
        return AdamState(
            u_base=u, m=m, v=v, lr=met[3], iteration=int(met[4]),
            loss=met[0], reg_loss=met[6], grad_squared=met[1],
            unitary_scale=met[2], done=met[5] > 0.5,
        )

    def unpad(u_padded):
        return u_padded.detach().cpu().numpy()[:, :T]

    return init_state, run_segment, unpad
