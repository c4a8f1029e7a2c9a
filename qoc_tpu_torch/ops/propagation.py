"""Time propagation engines, final-only subset (port of
``qoc_tpu.ops.propagation``).

Engines the port has:

  * ``tree``: the fused chain product (``ops.tree_chain``), the CUDA
    kernels on the card; final state / unitary only, exact gradients.
  * ``scan``: the serial chain, a Python loop of small matrix products;
    serves the analysis forward that needs intermediate states, and every
    run on the CPU.

qoc_tpu's ``associative`` and ``pscan`` engines and the reference-parity
gradient are not ported yet (ROADMAP.md, Queue 1); asking for them raises
``NotImplementedError``, and the ladders below never pick them.
"""

from __future__ import annotations

import torch

from .expm import taylor_expm, taylor_expm_matvec, weighted_hamiltonians
from .tree_chain import fused_tree_chain, tree_chain_supported

_NOT_PORTED = ("engine {!r} is not ported to qoc_tpu_torch yet (see "
               "ROADMAP.md, Queue 1); use engine='tree' or 'scan'")


def _require_exact(gradient_mode: str) -> None:
    if gradient_mode != "exact":
        raise NotImplementedError(
            f"gradient_mode={gradient_mode!r}: the reference-parity "
            "gradient is not ported to qoc_tpu_torch yet (ROADMAP.md, "
            "Queue 1); use gradient_mode='exact'")


def step_propagators(mats, weights, order: int, scaling: int):
    """All per-step propagators exp(sum_k w[k,t] mats[k]): [K,M,M], [K,T] -> [T,M,M]."""
    return taylor_expm(weighted_hamiltonians(mats, weights), order, scaling)


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


def pick_engine(dim_real: int, steps: int) -> str:
    """The unitary fallback rung.  qoc_tpu takes its associative engine
    while T copies of [M, M] fit in ~1 GiB; the port has no associative
    engine yet, so the serial scan serves every size."""
    del dim_real, steps
    return "scan"


def resolve_state_engine(M: int, T: int, gradient_mode: str,
                         final_only: bool, on_accel: bool) -> str:
    """State-transfer ladder: tree (final-only, exact, on the card, within
    ``tree_chain_supported``), else scan."""
    if (gradient_mode == "exact" and on_accel and final_only
            and tree_chain_supported(M, T)):
        return "tree"
    return "scan"


def resolve_unitary_engine(M: int, T: int, scaling: int, gradient_mode: str,
                           needs_inter: bool, on_accel: bool) -> str:
    """Unitary ladder: tree (final-only, exact, on the card), else
    ``pick_engine``."""
    del scaling
    if (gradient_mode == "exact" and on_accel and not needs_inter
            and tree_chain_supported(M, T)):
        return "tree"
    return pick_engine(M, T)


def state_transfer_chain(mats, weights, psi0, order: int,
                         gradient_mode: str = "exact", engine: str = "auto",
                         final_only: bool = False):
    """Evolve stacked state vectors psi0 [M, V] through all steps.

    Returns inter_vecs [T+1, M, V], or [1, M, V] (the final state) with
    ``final_only``.  Taylor convention of state transfer: powers
    0..order-1, no squaring.
    """
    _require_exact(gradient_mode)
    if engine == "auto":
        engine = resolve_state_engine(mats.shape[-1], weights.shape[-1],
                                      gradient_mode, final_only,
                                      weights.device.type == "cuda")
    if engine in ("associative", "pscan"):
        raise NotImplementedError(_NOT_PORTED.format(engine))

    if engine == "tree" and final_only:
        E = fused_tree_chain(mats, weights, order - 1, 0)
        return torch.matmul(E, psi0)[None]

    A = weighted_hamiltonians(mats, weights)
    psi = psi0
    vecs = [psi0]
    for t in range(A.shape[0]):
        psi = taylor_expm_matvec(A[t], psi, order)
        if not final_only:
            vecs.append(psi)
    if final_only:
        return psi[None]
    return torch.stack(vecs)


def evolve_unitary(mats, weights, U0, psi0, order: int, scaling: int,
                   gradient_mode: str = "exact", engine: str = "scan",
                   use_inter_vecs: bool = True):
    """Unitary-mode forward: (final_U, inter_vecs or None)."""
    _require_exact(gradient_mode)
    if engine in ("associative", "pscan"):
        raise NotImplementedError(_NOT_PORTED.format(engine))
    P = step_propagators(mats, weights, order, scaling)
    if not use_inter_vecs:
        if engine == "scan":
            return chain_scan_novecs(P, U0), None
        return torch.matmul(chain_product_tree(P), U0), None
    return chain_scan(P, U0, psi0)


def evolve_unitary_tree(mats, weights, U0, order: int, scaling: int):
    """Final unitary through the fused tree chain (final-only path)."""
    return torch.matmul(fused_tree_chain(mats, weights, order, scaling), U0)
