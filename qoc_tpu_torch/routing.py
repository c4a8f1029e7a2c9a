"""Engine routing announcements (port of ``qoc_tpu.routing``).

Every Grape run and every batched run prints ONE line naming the engine
(or batch backend) it landed on and, when a fused kernel was passed over,
why.  ``QOC_TPU_QUIET=1`` silences it, as in qoc_tpu.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .models.forward import INTER_VEC_COSTS
from .ops._cuda import (MAX_K, MAX_V, MAX_V_TRAJ, SMEM_LIMIT,
                        SUPPORTED_M, chain_fits)
from .ops.propagation import resolve_state_engine, resolve_unitary_engine
from .ops.tree_chain import tree_chain_supported


def announce(kind: str, choice: str, reasons=None) -> str:
    """Print and return the one-line routing decision."""
    line = f"[qoc-tpu-torch] {kind}: {choice}"
    if reasons:
        line += " (fallback: " + "; ".join(reasons) + ")"
    if os.environ.get("QOC_TPU_QUIET", "") != "1":
        print(line)
    return line


def fused_fallback_reasons(problem, reg_coeffs: Optional[dict],
                           gradient_mode: str = "exact",
                           sweep_mats: bool = False,
                           on_accel: bool = True) -> list:
    """Why the fused kernels were passed over, phrased for the user:
    the single-problem segment kernel (``ops.mega.mega_supported``) and
    the batch layer's kernels (``parallel.mega_batch.
    batched_mega_supported``, ``parallel.chain_batch.
    pallas_batch_supported``); mirrors qoc_tpu's reasons, with the CUDA
    kernels' bounds where qoc_tpu names its VMEM budget."""
    rc = reg_coeffs or {}
    reasons = []
    if not on_accel:
        reasons.append("cpu device (the fused kernels need a CUDA device)")
    if gradient_mode != "exact":
        reasons.append(
            f"gradient_mode={gradient_mode!r} (fused kernels are exact-grad)")
    if sweep_mats:
        reasons.append("per-seed generator sweep (mats_batch)")
    V = problem.initial_vectors.shape[1]
    traj = [k for k in INTER_VEC_COSTS if k in rc]
    vmax = MAX_V_TRAJ if traj else MAX_V
    if V > vmax:
        # the segment kernel takes V <= 16 (V <= 8 with trajectory costs);
        # the batch kernels take V <= 8; xla-cols takes any V
        reasons.append(f"V={V} concerned vectors exceed the fused "
                       f"kernels' {vmax}")
    if traj and not problem.use_inter_vecs:
        reasons.append("trajectory costs (%s) with use_inter_vecs=False"
                       % ", ".join(traj))
    M = 2 * problem.state_num
    K = problem.ops_len + 1
    if not tree_chain_supported(M, problem.steps):
        reasons.append(f"dim {M} x {problem.steps} steps exceeds the tree "
                       "chain's admission rule (the CUDA kernels are built "
                       f"for M in {SUPPORTED_M})")
    elif not chain_fits(K, M):
        reasons.append(f"{K} generators of {M}x{M} exceed the batch CUDA "
                       f"kernels' bounds (at most {MAX_K}, within "
                       f"{SMEM_LIMIT} bytes of shared memory)")
    return reasons or ["unsupported cost combination for the fused kernels"]


def resolve_single_engine(problem, reg_coeffs, gradient_mode: str,
                          engine: str, lean: bool = True,
                          device="cuda") -> str:
    """The engine the per-iteration ``Grape`` forward resolves to on
    ``device``: the same ladders ``models.forward`` uses (qoc_tpu/
    routing.py:77-106, where the device is JAX's default backend)."""
    p = problem
    M = 2 * p.state_num
    if lean:
        needs_inter = p.use_inter_vecs and any(
            k in (reg_coeffs or {}) for k in INTER_VEC_COSTS)
    else:
        needs_inter = p.use_inter_vecs
    on_accel = torch.device(device).type == "cuda"
    if engine != "auto":
        return engine
    if p.state_transfer:
        return resolve_state_engine(M, p.steps, gradient_mode,
                                    not needs_inter, on_accel)
    if gradient_mode != "exact":
        return resolve_unitary_engine(M, p.steps, 0, "reference",
                                      needs_inter, False)
    return resolve_unitary_engine(M, p.steps, p.taylor_scaling,
                                  gradient_mode, needs_inter, on_accel)
