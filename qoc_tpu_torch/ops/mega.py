"""Fused Adam segments: n full GRAPE iterations per launch (port of
``qoc_tpu.ops.pallas_mega``, the fidelity objective plus all seven
penalties).

On the card, ``run_segment`` launches the hand-written CUDA kernel of
``csrc/mega.cuh``: sin-bounded weights, Taylor steps, the chain product,
the coherent fidelity and ``unitary_scale``, the penalties, the exact
backward, Adam with bias correction and exponential LR decay, the
convergence test and the freeze, for n iterations in one launch.  The
fidelity-only objective runs the kernel's plain instance
(``_cuda.mega_segment``, a pairwise product tree); any penalty runs its
costs instance (``_cuda.mega_segment_costs``), which adds the pulse-shape
penalties, the bandpass DFT products and, when ``forbidden`` or
``speed_up`` reads the trajectory, an inclusive prefix scan in place of
the tree.

``mega_segment_reference`` is the plain torch version: the same forward
(the tree, or the prefix products P_t...P_0 applied to psi0p), the
penalties of ``models.costs``, autograd for the gradient, and the
kernel's own Adam, bias-correction and freeze arithmetic.  The runner
uses the plain version for a problem held on the CPU only.

Semantics (``qoc_tpu.ops.pallas_mega``, ``optim/adam.py``): metrics are
evaluated at the current iterate; ``loss < conv_target | grad^2 <
min_grad | iteration >= max_iterations`` (the fidelity loss, not
``reg_loss``) then freezes u, m, v, the LR and the count; the metrics a
segment returns belong to the last evaluated iterate and start as inf.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..interop import adam_state_from_numpy, problem_tensors
from ..models.costs import CostContext, total_reg_cost
from ..optim.adam import B1, B2, EPS, AdamState, decay_factor
from ..utils.profiling import span
from . import _cuda
from .expm import taylor_expm, weighted_hamiltonians
from .tree_chain import next_pow2, tree_chain_reference, tree_chain_supported

_MEGA_COSTS = ("amplitude", "envelope", "dwdt", "d2wdt2", "bandpass", "band",
               "speed_up")
_MEGA_FORB_KEYS = ("forbidden_coeff_list", "forbidden",
                   "states_forbidden_list", "forbid_dressed")


def _forbidden_pairs(reg_coeffs):
    """[(coeff, level), ...] from either spelling, or []."""
    rc = reg_coeffs or {}
    coeffs = rc.get("forbidden_coeff_list", rc.get("forbidden"))
    if coeffs is None:
        return []
    return list(zip(coeffs, rc["states_forbidden_list"]))


def _has_traj(reg_coeffs) -> bool:
    return bool(_forbidden_pairs(reg_coeffs)) or "speed_up" in (
        reg_coeffs or {})


def mega_supported(problem, reg_coeffs=None, gradient_mode="exact") -> bool:
    """qoc_tpu's gate: the fidelity objective plus any of the seven
    penalties, exact gradients, V <= 16 concerned vectors (V <= 8 and
    use_inter_vecs when a cost reads the trajectory), ``bandpass`` only
    with ``band``, and tree-supported sizes."""
    rc = reg_coeffs or {}
    extra = set(rc) - set(_MEGA_COSTS) - set(_MEGA_FORB_KEYS)
    V = problem.initial_vectors.shape[1]
    if _has_traj(rc) and (not problem.use_inter_vecs
                          or V > _cuda.MAX_V_TRAJ):
        return False
    if "bandpass" in rc and "band" not in rc:
        return False
    return (not extra and gradient_mode == "exact" and V <= _cuda.MAX_V
            and tree_chain_supported(2 * problem.state_num, problem.steps))


def segment_lanes(problem, reg_coeffs=None) -> int:
    """Lane count Tp: the next power of two >= T, doubled when a
    difference cost needs the two zero lanes past T (the reference's
    2-zero padding) and T is a power of two."""
    rc = reg_coeffs or {}
    T = problem.steps
    Tp = next_pow2(max(T, 2))
    if (rc.get("dwdt") or rc.get("d2wdt2")) and Tp < T + 2:
        Tp *= 2
    return Tp


def forbidden_static(problem, reg_coeffs):
    """(rows [n, 1 + 2M] float64, c0) for the forbidden penalties.

    Row i is (alpha_i, rs_i, rns_i): alpha = coeff/steps and the level's
    projection rows rs[j] = R[j, s], rns[j] = R[j, N+s], with the dressed
    rotation R folded in when ``forbid_dressed`` and the problem is
    dressed (one-hot otherwise).  ``c0`` is the constant t = 0 term: the
    trajectory's entry 0 is the RAW initial vectors in both modes.
    """
    rc = reg_coeffs or {}
    Nc = problem.state_num
    M = 2 * Nc
    R = (np.asarray(problem.v_sorted_iso, dtype=np.float64)
         if problem.v_sorted_iso is not None and rc.get("forbid_dressed",
                                                        False)
         else np.eye(M))
    iv0 = np.asarray(problem.initial_vectors, dtype=np.float64)   # [2N, V]
    rot0 = R.T @ iv0
    rows, c0 = [], 0.0
    for coeff, s in _forbidden_pairs(rc):
        alpha = float(coeff) / problem.steps
        rows.append(np.concatenate([[alpha], R[:, s], R[:, Nc + s]]))
        pop0 = rot0[s] ** 2 + rot0[Nc + s] ** 2
        c0 += alpha * 0.5 * float(np.sum(pop0 ** 2))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 1 + 2 * M), c0


def _bandpass_bins(problem, reg_coeffs) -> np.ndarray:
    """The penalized bins [0, band0*total_time) and [band1*total_time,
    steps/2) of the T-point FFT (regularization_functions.py:59-65)."""
    band = np.asarray(reg_coeffs["band"], dtype=float)
    band_id = (band * float(problem.total_time)).astype(int)
    half_id = int(problem.steps / 2)
    return np.concatenate([np.arange(0, max(int(band_id[0]), 0)),
                           np.arange(int(band_id[1]), half_id)])


class SegmentCosts(NamedTuple):
    """What the costs instance of the segment kernel and the plain segment
    read besides the fidelity operands.  Coefficients are coeff/steps."""

    reg_coeffs: dict
    traj: bool                 # forbidden or speed_up: prefix-scan topology
    a_amp: float
    a_env: float
    a_dwdt: float
    a_d2: float
    inv_dt: float
    a_bp: float
    a_spd: float
    spd_c0: float              # speed_up's constant t = 0 overlap term
    forb_c0: float             # forbidden's constant t = 0 term
    env: torch.Tensor          # [Kc, Tp] envelope mask, zero past T
    forb: torch.Tensor         # [n, 1 + 2M] (alpha, rs, rns) rows
    dftc: torch.Tensor         # [Tp, F] cos of the penalized bins
    dfts: torch.Tensor         # [Tp, F] sin
    dftct: torch.Tensor        # [F, Tp] transposes (coalesced reads)
    dftst: torch.Tensor
    # the plain version's CostContext
    psi0: torch.Tensor         # [2N, V] raw initial vectors
    one_minus_gauss: torch.Tensor   # [Kc, T]
    v_sorted_iso: Optional[torch.Tensor]
    dt: float
    total_time: float


def bandpass_angles(problem, reg_coeffs):
    """(a_bp, ang [T, F]): the bandpass coefficient / steps (0 when no bin
    is penalized) and the float64 DFT angles 2 pi t f / T of the
    penalized bins."""
    T = problem.steps
    a_bp = float(reg_coeffs.get("bandpass", 0.0)) / T
    bins = _bandpass_bins(problem, reg_coeffs) if a_bp else np.zeros(0)
    if bins.size == 0:
        a_bp = 0.0
    return a_bp, 2.0 * np.pi * np.arange(T)[:, None] * bins[None, :] / float(T)


def speed_up_c0(problem) -> float:
    """speed_up's constant t = 0 term |<psi0|target>|^2 / V^2 in float64;
    inter_vecs[0] is the RAW initial vectors in both modes
    (tensorflow_state.py:230-236)."""
    iv0 = np.asarray(problem.initial_vectors, dtype=np.float64)
    tv = np.asarray(problem.target_vectors, dtype=np.float64)
    Nc = problem.state_num
    re0 = float(np.sum(iv0[:Nc] * tv[:Nc]) + np.sum(iv0[Nc:] * tv[Nc:]))
    im0 = float(np.sum(iv0[Nc:] * tv[:Nc]) - np.sum(iv0[:Nc] * tv[Nc:]))
    return (re0 * re0 + im0 * im0) / float(iv0.shape[1] ** 2)


def segment_costs(problem, reg_coeffs, device) -> Optional[SegmentCosts]:
    """The cost statics of ``pallas_mega.make_mega_segment_runner``
    (:496-577) as tensors on ``device``; None for the fidelity-only
    objective.  The DFT matrices are built in float64 and stored in f32."""
    rc = reg_coeffs or {}
    if not rc:
        return None
    p = problem
    T = p.steps
    Tp = segment_lanes(p, rc)
    tens = problem_tensors(p, device)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                               device=device)

    a_bp, ang = bandpass_angles(p, rc)
    dftc = np.zeros((Tp, ang.shape[1]))
    dfts = np.zeros((Tp, ang.shape[1]))
    dftc[:T] = np.cos(ang)
    dfts[:T] = np.sin(ang)

    a_spd = float(rc.get("speed_up", 0.0)) / T
    spd_c0 = speed_up_c0(p) if a_spd else 0.0

    forb, forb_c0 = forbidden_static(p, rc)
    env = np.pad(np.asarray(p.one_minus_gauss, dtype=np.float32),
                 ((0, 0), (0, Tp - T)))
    return SegmentCosts(
        reg_coeffs=dict(rc), traj=_has_traj(rc),
        a_amp=float(rc.get("amplitude", 0.0)) / T,
        a_env=float(rc.get("envelope", 0.0)) / T,
        a_dwdt=float(rc.get("dwdt", 0.0)) / T,
        a_d2=float(rc.get("d2wdt2", 0.0)) / T,
        inv_dt=1.0 / float(p.dt), a_bp=a_bp, a_spd=a_spd, spd_c0=spd_c0,
        forb_c0=forb_c0, env=dev(env), forb=dev(forb), dftc=dev(dftc),
        dfts=dev(dfts), dftct=dev(dftc.T), dftst=dev(dfts.T),
        psi0=tens["initial_vectors"],
        one_minus_gauss=tens["one_minus_gauss"],
        v_sorted_iso=tens.get("v_sorted_iso"), dt=float(p.dt),
        total_time=float(p.total_time))


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


def prefix_products(P: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products X[t] = P[t] @ ... @ P[0] of [Tp, M, M] by
    the kernel's Hillis-Steele levels (level d: X[t] @ X[t-d], later time
    on the left; lanes t < d keep their value)."""
    X = P
    d = 1
    while d < X.shape[0]:
        X = torch.cat([X[:d], torch.matmul(X[d:], X[:-d])])
        d *= 2
    return X


def mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                           state: AdamState, n: int, *, N: int, T: int,
                           order: int, scaling: int, unitary_mode: bool,
                           rate_factor: float, conv_target: float,
                           min_grad: float, max_iterations: float,
                           costs: Optional[SegmentCosts] = None
                           ) -> AdamState:
    """Plain torch segment: ``n`` iterations of the kernel's arithmetic,
    with autograd for the gradient and float32 scalars throughout.
    Operands as ``_cuda.mega_segment`` takes them (u0rows [M]); ``costs``
    adds the penalties (``segment_costs``)."""
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
    loss = g2 = reg_loss = torch.tensor(float("inf"), **f32)
    uscale = torch.tensor(0.0, **f32)
    traj = costs is not None and costs.traj
    for _ in range(n):
        uu = u.detach().requires_grad_(True)
        w = torch.cat([live[None], maxamp[:, None] * (torch.sin(uu) * live)])
        if traj:
            X = prefix_products(taylor_expm(weighted_hamiltonians(mats, w),
                                            order, scaling))
            E = X[T - 1]
        else:
            E = tree_chain_reference(mats, w, order, scaling)
        final = torch.matmul(E, psi0p)
        fa, fb = final[:N], final[N:]
        re = torch.sum(fa * ta) + torch.sum(fb * tb)
        im = torch.sum(fb * ta) - torch.sum(fa * tb)
        loss_t = 1.0 - (re * re + im * im) / (V * V)
        reg_loss_t = loss_t
        if costs is not None:
            c = costs
            inter = None
            if traj:   # entry 0 is the raw psi0, then psi_{t+1} = X[t] psi0p
                inter = torch.cat([c.psi0.to(mats.dtype)[None],
                                   torch.matmul(X[:T], psi0p)])
            ctx = CostContext(
                ops_weight=torch.sin(uu[:, :T]), inter_vecs=inter,
                target_vecs=target, state_num=N, steps=T, dt=c.dt,
                total_time=c.total_time,
                one_minus_gauss=c.one_minus_gauss.to(mats.dtype),
                v_sorted_iso=(None if c.v_sorted_iso is None
                              else c.v_sorted_iso.to(mats.dtype)))
            reg_loss_t = loss_t + total_reg_cost(ctx, c.reg_coeffs)
        (g,) = torch.autograd.grad(reg_loss_t, uu)
        with torch.no_grad():
            loss = loss_t.detach()
            reg_loss = reg_loss_t.detach()
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
        loss=float(loss), reg_loss=float(reg_loss), grad_squared=float(g2),
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
        rate_factor=decay_factor(conv),
        conv_target=conv_target, min_grad=min_grad,
        max_iterations=max_iterations)


def make_mega_segment_runner(problem, conv, throughput: bool = False,
                             reg_coeffs=None, device="cpu"):
    """(init_state, run_segment, unpad) for the fused segment.

    ``run_segment(state, n, clocks=None)`` advances up to ``n`` iterations
    with the convergence semantics of ``optim.adam``; ``throughput=True``
    disables the convergence test (fixed-count timing).  ``clocks`` (CUDA
    only) is the kernel's clock64 buffer (``_cuda.mega_segment``).  ``reg_coeffs`` selects the
    penalties (any that ``mega_supported`` admits).  On a CUDA ``device``
    each segment is one launch of the CUDA kernel; on the CPU it runs
    ``mega_segment_reference``.
    """
    p = problem
    device = torch.device(device)
    T = p.steps
    Tp = segment_lanes(p, reg_coeffs)
    mats, psi0p, target, maxamp, u0rows, order, scaling = segment_inputs(
        p, device)
    costs = segment_costs(p, reg_coeffs, device)
    statics = dict(segment_statics(p, conv, throughput), order=order,
                   scaling=scaling)
    scratch = []

    def init_state(u_base) -> AdamState:
        zeros = np.zeros(np.shape(u_base), dtype=np.float32)
        return adam_state_from_numpy(u_base, zeros, zeros, 0, conv.rate, T,
                                     Tp, device)

    def run_segment(state: AdamState, n: int, clocks=None) -> AdamState:
        if device.type == "cpu":
            if clocks is not None:
                raise ValueError("clocks count the CUDA kernel's cycles; "
                                 "the plain version has none")
            return mega_segment_reference(mats, psi0p, target, maxamp,
                                          u0rows, state, int(n),
                                          costs=costs, **statics)
        with span("qoc.mega.prepare"):
            K, M = mats.shape[0], mats.shape[1]
            if not scratch:
                scratch.extend(
                    _cuda.mega_scratch(K, Tp, device)
                    if costs is None else
                    _cuda.mega_costs_scratch(K, M, Tp, psi0p.shape[1], order,
                                             scaling, costs.dftc.shape[1],
                                             costs.traj, device))
            u = state.u_base.clone()
            m = state.m.clone()
            v = state.v.clone()
            sf = torch.tensor([state.lr, float(state.iteration),
                               float(state.done)], dtype=torch.float32,
                              device=device)
            args = (mats, psi0p, target, maxamp, u0rows, u, m, v, sf)
            kw = dict(n_iters=int(n), b1=B1, b2=B2, eps=EPS,
                      scratch=tuple(scratch), clocks=clocks, **statics)
            if costs is None:
                met = _cuda.mega_segment(*args, **kw)
            else:
                met = _cuda.mega_segment_costs(*args, costs=costs, **kw)
        met = met.tolist()
        return AdamState(
            u_base=u, m=m, v=v, lr=met[3], iteration=int(met[4]),
            loss=met[0], reg_loss=met[6], grad_squared=met[1],
            unitary_scale=met[2], done=met[5] > 0.5,
        )

    def unpad(u_padded):
        return u_padded.detach().cpu().numpy()[:, :T]

    return init_state, run_segment, unpad
