"""Engine routing announcements (port of ``qoc_tpu.routing``).

Every Grape run prints ONE line naming the engine it landed on and, when
the fused segment kernel was passed over, why.  ``QOC_TPU_QUIET=1``
silences it, as in qoc_tpu.
"""

from __future__ import annotations

import os
from typing import Optional

from .models.forward import INTER_VEC_COSTS
from .ops._cuda import MAX_V, MAX_V_TRAJ
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
                           on_accel: bool = True) -> list:
    """Why the fused segment kernel (ops.mega.mega_supported) was passed
    over, phrased for the user; mirrors qoc_tpu's reasons."""
    rc = reg_coeffs or {}
    reasons = []
    if not on_accel:
        reasons.append("cpu device (the fused kernels need a CUDA device)")
    if gradient_mode != "exact":
        reasons.append(
            f"gradient_mode={gradient_mode!r} (fused kernels are exact-grad)")
    V = problem.initial_vectors.shape[1]
    traj = [k for k in INTER_VEC_COSTS if k in rc]
    vmax = MAX_V_TRAJ if traj else MAX_V
    if V > vmax:
        reasons.append(f"V={V} concerned vectors exceed the segment "
                       f"kernel's {vmax}")
    if traj and not problem.use_inter_vecs:
        reasons.append("trajectory costs (%s) with use_inter_vecs=False"
                       % ", ".join(traj))
    M = 2 * problem.state_num
    if not tree_chain_supported(M, problem.steps):
        reasons.append(f"dim {M} x {problem.steps} steps exceeds the tree "
                       "chain's admission rule")
    return reasons or ["unsupported cost combination for the fused kernels"]
