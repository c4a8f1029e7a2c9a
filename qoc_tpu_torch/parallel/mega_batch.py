"""Fused batched-optimizer segments: n complete GRAPE iterations for every
seed of a population per launch (port of
``qoc_tpu.parallel.pallas_mega_batch``, the ``"mega"`` backend).

On the card, ``run_n`` launches kernel 6 (``csrc/mega_batch.cuh``): a
team of lanes per column (c = seed * V + v), the V teams of a seed in
one block, the column chain storing the trajectory, the coherent
per-seed fidelity, all seven penalties, the exact reverse sweep, and
Adam with a per-seed freeze, count and learning rate.  The fidelity
objective runs the kernel's plain instance (``_cuda`` name
``mega_batch_segment``); any penalty its costs instance
(``mega_batch_segment_costs``).  Hamiltonian sweeps ride constant-weight
extra operator channels.

``mega_batch_segment_reference`` is the plain torch version: the
column-batched loss of ``parallel.cols_batch``, autograd for the gradient
of the summed reg_loss, and the kernel's own predicates, freeze and Adam
(pallas_mega_batch.py:514-560).  The runner uses it for a problem held on
the CPU only.

With ``mesh=`` (``parallel.mesh``) every rank runs kernel 6 on its own
shard of the seeds' columns; nothing crosses ranks inside a segment.

One deliberate difference from qoc_tpu: the reported grad^2 is the seed's
true norm 0.5 * sum g^2, which qoc_tpu's other backends and ``Grape``
report; qoc_tpu's fused kernel divides it by V (pallas_mega_batch.py:
528-529), which also shifts its ``min_grad`` test.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..interop import entry_device, problem_tensors
from ..ops import _cuda
from ..ops.mega import (_MEGA_FORB_KEYS, bandpass_angles,
                        forbidden_static, speed_up_c0)
from ..optim.adam import B1, B2, EPS, decay_factor
from ..utils.profiling import span
from .cols_batch import chain_inputs, chain_order, make_xla_batched_loss
from .mesh import gather, local_shard

_BATCH_PULSE_KEYS = ("amplitude", "envelope", "dwdt", "d2wdt2", "bandpass",
                     "band")


def batched_mega_supported(problem, reg_coeffs: Optional[dict] = None
                           ) -> bool:
    """qoc_tpu's semantic rules (pallas_mega_batch.py:150-163): the
    fidelity plus any of the seven penalties, ``bandpass`` only with
    ``band``, trajectory penalties only with use_inter_vecs, the
    difference penalties only from 4 steps, V <= 8; and the CUDA kernel's
    own bounds (``_cuda.chain_fits``: M, K, and the shared memory of a
    step's replayed powers at this order, scaling and V) in place of the
    TPU VMEM budget."""
    rc = reg_coeffs or {}
    if rc:
        if set(rc) - set(_MEGA_FORB_KEYS) - set(_BATCH_PULSE_KEYS) - {
                "speed_up"}:
            return False
        if "bandpass" in rc and "band" not in rc:
            return False
        traj_keys = tuple(_MEGA_FORB_KEYS) + ("speed_up",)
        if any(k in rc for k in traj_keys) and not problem.use_inter_vecs:
            return False
        if (rc.get("dwdt") or rc.get("d2wdt2")) and problem.steps < 4:
            return False
    V = problem.initial_vectors.shape[1]
    if V > _cuda.MAX_V_BATCH:
        return False
    return _cuda.chain_fits(problem.ops_len + 1, 2 * problem.state_num,
                            *chain_order(problem), V)


class BatchCosts(NamedTuple):
    """What kernel 6's costs instance reads besides the fidelity operands.
    Coefficients are coeff/steps; c_dwdt and c_d2 carry the extra 1/dt^2
    of the difference gradients."""

    a_amp: float
    a_env: float
    a_dwdt: float
    c_dwdt: float
    a_d2: float
    c_d2: float
    inv_dt: float
    idt2: float
    a_bp: float
    a_spd: float
    spd_c0: float            # speed_up's constant t = 0 overlap term
    forb_c0: float           # forbidden's constant t = 0 term
    env2: torch.Tensor       # [T, Kc] squared envelope mask
    forb: torch.Tensor       # [n, 1 + 2M] (alpha, rs, rns) rows
    dftc: torch.Tensor       # [T, F] cos of the penalized bins
    dfts: torch.Tensor       # [T, F] sin


def batch_costs(problem, reg_coeffs, device) -> Optional[BatchCosts]:
    """The penalty statics of ``make_mega_batched_runner``
    (pallas_mega_batch.py:717-758) as tensors on ``device``; None when no
    penalty is on.  The DFT matrices are built in float64 and stored in
    float32."""
    rc = reg_coeffs or {}
    p = problem
    T = p.steps

    def coeff(key):
        return float(rc.get(key, 0.0)) / T

    a_bp, ang = bandpass_angles(p, rc)
    forb, forb_c0 = forbidden_static(p, rc)
    a_spd = coeff("speed_up")
    if not (coeff("amplitude") or coeff("envelope") or coeff("dwdt")
            or coeff("d2wdt2") or a_bp or len(forb) or a_spd):
        return None
    spd_c0 = speed_up_c0(p) if a_spd else 0.0
    env2 = (np.asarray(p.one_minus_gauss, dtype=np.float32) ** 2).T

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                               device=device)

    inv_dt = 1.0 / float(p.dt)
    return BatchCosts(
        a_amp=coeff("amplitude"), a_env=coeff("envelope"),
        a_dwdt=coeff("dwdt"), c_dwdt=coeff("dwdt") * inv_dt * inv_dt,
        a_d2=coeff("d2wdt2"), c_d2=coeff("d2wdt2") * inv_dt * inv_dt,
        inv_dt=inv_dt, idt2=inv_dt * inv_dt, a_bp=a_bp, a_spd=a_spd,
        spd_c0=spd_c0, forb_c0=forb_c0, env2=dev(env2), forb=dev(forb),
        dftc=dev(np.cos(ang)), dfts=dev(np.sin(ang)))


class MegaBatchState(NamedTuple):
    """qoc_tpu's layout: controls time-major on columns c = seed * V + v."""

    u_cols: torch.Tensor      # [T, Kc, C]
    m_cols: torch.Tensor
    v_cols: torch.Tensor
    it_cols: torch.Tensor     # [1, C] per-seed applied-update counts
    done_cols: torch.Tensor   # [1, C] per-seed frozen flags (0/1)
    iteration: int            # kernel iterations driven so far
    losses: Optional[torch.Tensor]        # [S] after the first segment
    grad_squared: Optional[torch.Tensor]  # [S]
    reg_losses: Optional[torch.Tensor] = None   # [S] loss + penalties


def batch_segment_statics(conv, throughput: bool = False) -> dict:
    """The segment's scalar settings (keyword arguments of
    ``mega_batch_segment_reference``); ``throughput`` turns the
    convergence predicates off."""
    if throughput:
        conv_target, min_grad, max_iterations = -1.0, -1.0, float(2 ** 30)
    else:
        conv_target = float(conv.conv_target)
        min_grad = float(conv.min_grad)
        max_iterations = float(conv.max_iterations)
    return dict(rate=float(conv.rate),
                factor=decay_factor(conv),
                conv_target=conv_target, min_grad=min_grad,
                max_iterations=max_iterations)


def mega_batch_segment_reference(batched_loss, state: MegaBatchState, n: int,
                                 *, V: int, rate: float, factor: float,
                                 conv_target: float, min_grad: float,
                                 max_iterations: float, extra_weights=None
                                 ) -> MegaBatchState:
    """Plain torch: ``n`` iterations of kernel 6's arithmetic.
    ``batched_loss`` is ``cols_batch.make_xla_batched_loss``'s function
    (its dtype decides the segment's); metrics at the current iterate,
    then the per-seed predicates on the fidelity loss, the freeze, and
    the kernel's Adam (lr = rate * exp(ln f * it), bias corrections with
    it + 1)."""
    u, m, v = state.u_cols, state.m_cols, state.v_cols
    it, done = state.it_cols[0], state.done_cols[0]
    ln_b1, ln_b2, ln_f = math.log(B1), math.log(B2), math.log(factor)
    losses, g2, regs = state.losses, state.grad_squared, state.reg_losses
    for _ in range(n):
        u_s = u[:, :, ::V].permute(2, 1, 0).detach().requires_grad_(True)
        reg, fid = batched_loss(u_s, extra_weights)
        (g,) = torch.autograd.grad(reg.sum(), u_s)
        with torch.no_grad():
            g2 = 0.5 * torch.sum(g * g, dim=(1, 2))          # [S]
            conv = ((fid < conv_target) | (g2 < min_grad)
                    | (it[::V] >= max_iterations))
            dn = torch.maximum(done[::V], conv.to(u.dtype))
            dn = torch.repeat_interleave(dn, V)               # [C]
            do = (1.0 - dn)[None, None, :]
            gc = torch.repeat_interleave(g.permute(2, 1, 0), V, dim=2)
            mm = B1 * m + (1.0 - B1) * gc
            vv = B2 * v + (1.0 - B2) * (gc * gc)
            cnt = it + 1.0
            lr = rate * torch.exp(ln_f * it)
            bc1 = 1.0 - torch.exp(cnt * ln_b1)
            bc2 = 1.0 - torch.exp(cnt * ln_b2)
            upd = (mm / bc1) / (torch.sqrt(vv / bc2) + EPS)
            u = u - do * (lr * upd)
            m = m + do * (mm - m)
            v = v + do * (vv - v)
            it = it + (1.0 - dn)
            done = dn
            losses, regs = fid.detach(), reg.detach()
        if bool(torch.all(done > 0.5)):
            break   # later iterations would recompute the frozen metrics
    return MegaBatchState(
        u_cols=u.detach(), m_cols=m, v_cols=v, it_cols=it[None],
        done_cols=done[None], iteration=state.iteration + int(n),
        losses=losses, grad_squared=g2, reg_losses=regs)


def make_mega_batched_runner(problem, conv, extra_channel_mats=None,
                             mesh=None, throughput: bool = False,
                             reg_coeffs: Optional[dict] = None,
                             device=None):
    """(init_state, run_n, read_u): batched Adam segments with per-seed
    convergence freezing, one kernel launch per segment on the CUDA card
    (``device=None``; ``device="cpu"`` runs the plain version).

    ``init_state(u_bases [S, Kc, T])``; ``run_n(state, n, extra_weights
    [S, E], clocks)`` drives n iterations (frozen seeds stay frozen;
    ``clocks``, on the card only, is ``_cuda.mega_batch_segment``'s
    counter buffer);
    ``read_u(state) -> numpy [S, Kc, T]``.  ``throughput=True`` turns the
    convergence predicates off (fixed-count timing).

    With ``mesh`` (``parallel.mesh.make_mesh``), ``init_state`` and
    ``run_n`` take the global seed batch and extra weights and keep this
    rank's shard: the state, its losses included, holds the rank's
    columns (``parallel.mesh.gather`` gives the global arrays), and ``read_u``
    returns the global pulses."""
    p = problem
    if not batched_mega_supported(p, reg_coeffs):
        raise ValueError("problem outside the fused batched-optimizer scope")
    device = entry_device(device)
    T, Kc = p.steps, p.ops_len
    mats, psi0, order, scaling = chain_inputs(p, extra_channel_mats, device)
    E = mats.shape[0] - 1 - Kc
    M, V = psi0.shape
    tens = problem_tensors(p, device)
    tgt, maxamp = tens["target_vectors"], tens["ops_max_amp"]
    costs = batch_costs(p, reg_coeffs, device)
    statics = batch_segment_statics(conv, throughput)
    # the plain version stores the trajectory, as the kernel does
    batched_loss = (make_xla_batched_loss(p, reg_coeffs, extra_channel_mats,
                                          remat=False)
                    if device.type == "cpu" else None)
    adam = dict(b1=B1, b2=B2, one_minus_b1=1.0 - B1, one_minus_b2=1.0 - B2,
                eps=EPS, ln_b1=math.log(B1), ln_b2=math.log(B2),
                ln_f=math.log(statics["factor"]), rate=statics["rate"],
                conv_target=statics["conv_target"],
                min_grad=statics["min_grad"],
                max_iterations=statics["max_iterations"])
    scratch: dict = {}

    def shard(x):
        return x if mesh is None else local_shard(x, mesh)

    def init_state(u_bases) -> MegaBatchState:
        if mesh is not None and u_bases.shape[0] % mesh.size():
            raise ValueError(
                f"column count {u_bases.shape[0] * V} not divisible by mesh "
                f"size {mesh.size()} x V={V}")
        u = torch.as_tensor(np.asarray(u_bases, dtype=np.float32)
                            if not torch.is_tensor(u_bases) else u_bases,
                            device=device).to(torch.float32)
        u = shard(u)
        u_cols = torch.repeat_interleave(u.permute(2, 1, 0), V,
                                         dim=2).contiguous()
        C = u_cols.shape[2]
        zeros = torch.zeros((1, C), dtype=torch.float32, device=device)
        return MegaBatchState(
            u_cols=u_cols, m_cols=torch.zeros_like(u_cols),
            v_cols=torch.zeros_like(u_cols), it_cols=zeros,
            done_cols=zeros.clone(), iteration=0, losses=None,
            grad_squared=None)

    def column_extra_weights(extra_weights, C):
        if not E:
            return torch.zeros((1, C), dtype=torch.float32, device=device)
        ew = torch.as_tensor(extra_weights, dtype=torch.float32,
                             device=device)
        return torch.repeat_interleave(ew.T, V, dim=1).contiguous()

    def run_n(state: MegaBatchState, n: int, extra_weights=None,
              clocks=None) -> MegaBatchState:
        if int(n) <= 0:
            return state
        if E:
            extra_weights = shard(extra_weights)
        if device.type == "cpu":
            ew = (None if not E else
                  torch.as_tensor(extra_weights, dtype=torch.float32))
            return mega_batch_segment_reference(
                batched_loss, state, int(n), V=V, extra_weights=ew,
                **statics)
        with span("qoc.mega_batch.prepare"):
            C = state.u_cols.shape[2]
            if C not in scratch:
                scratch[C] = (
                    _cuda.mega_batch_scratch(M, T, Kc, C, V, device),
                    None if costs is None else _cuda.mega_batch_costs_scratch(
                        T, Kc, C, V, costs.dftc.shape[1], device))
            u, m, v = (x.clone() for x in (state.u_cols, state.m_cols,
                                           state.v_cols))
            itc, done = state.it_cols.clone(), state.done_cols.clone()
            stats = _cuda.mega_batch_segment(
                mats, maxamp, psi0, tgt,
                column_extra_weights(extra_weights, C), u, m, v, itc, done,
                order=order, scaling=scaling, n_iters=int(n), adam=adam,
                scratch=scratch[C][0], costs=costs,
                cost_scratch=scratch[C][1], clocks=clocks)
        return MegaBatchState(
            u_cols=u, m_cols=m, v_cols=v, it_cols=itc, done_cols=done,
            iteration=state.iteration + int(n), losses=stats[0, ::V],
            grad_squared=stats[1, ::V], reg_losses=stats[2, ::V])

    def read_u(state: MegaBatchState) -> np.ndarray:
        u = state.u_cols[:, :, ::V].permute(2, 1, 0)
        return (u if mesh is None else gather(u, mesh)).cpu().numpy()

    return init_state, run_n, read_u
