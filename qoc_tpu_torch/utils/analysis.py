"""Readout: device arrays -> complex numpy + h5 appends.

A copy of ``qoc_tpu.utils.analysis``; h5py is imported only by the append
functions, on the save path.

Replaces core/analysis.py.  The reference's Analysis `.eval()`s live-session
tensors; here the forward model returns concrete arrays, so this module only
converts representations and persists the same h5 schema (error, reg_error,
uks, iteration, run_time, unitary_scale, final_state, inter_vecs_raw_*,
inter_vecs_mag_squared, inter_vecs_real/imag; run_session.py:129-137,
analysis.py:26-101).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.dressed import sort_ev
from ..models.system import ControlProblem
from ..ops.isomorphism import r_to_c_mat


def uks_from_base(problem: ControlProblem, u_base: np.ndarray) -> np.ndarray:
    """Physical pulse amplitudes maxA * sin(base) [K, T] (run_session.py:112-117)."""
    return np.asarray(problem.ops_max_amp)[:, None] * np.sin(np.asarray(u_base))


def final_state_to_complex(problem: ControlProblem, final_state: np.ndarray):
    """Final unitary (or stacked final vectors) back to complex (analysis.py:18-35)."""
    M = np.asarray(final_state)
    n = problem.state_num
    if problem.state_transfer:
        return M[:n, :] + 1j * M[n : 2 * n, :]
    return r_to_c_mat(M)


def inter_vecs_to_complex(problem: ControlProblem, inter_vecs: np.ndarray):
    """[T+1, 2N, V] real iso -> [V, N, T+1] complex, the reference's
    per-initial-vector layout (analysis.py:60-70)."""
    n = problem.state_num
    v = np.asarray(inter_vecs)
    vc = v[:, :n, :] + 1j * v[:, n : 2 * n, :]  # [T+1, N, V]
    return np.transpose(vc, (2, 1, 0))  # [V, N, T+1]


def fidelity_f64(problem: ControlProblem, uks: np.ndarray,
                 order: Optional[int] = None) -> float:
    """Final fidelity recomputed in float64 by the framework's OWN Taylor
    propagation (numpy complex128) — the optimizer's algorithm class,
    freed of its float32 accumulation noise.

    The on-device forward runs float32: over ~1000 steps at Hilbert dims
    >= 50 the reported fidelity carries an irreducible ~1e-5 rounding
    floor (measured: config 4's f32 recompute is identical at Taylor
    order 15 and 20, so truncation contributes nothing — the gap to the
    float64 oracles is pure f32 accumulation).  This readout removes the
    representation noise so the BASELINE "fidelity delta < 1e-6 vs an
    independent oracle" criterion compares *algorithms* (Taylor vs Pade
    vs adaptive ODE), not float widths.  It is reported alongside — not
    instead of — the optimizer's own float32 loss.

    Cost: steps x order [N,N]@[N,V] complex matvecs on host (per-step
    scaling-and-squaring when the step norm needs it); microseconds to
    milliseconds next to any real run.
    """
    n = problem.state_num
    dt = problem.dt
    H0 = np.asarray(problem.H0_c, dtype=np.complex128)
    Hops = [np.asarray(h, dtype=np.complex128) for h in problem.ops_c]
    uks = np.asarray(uks, dtype=np.float64)
    if order is None:
        order = max(problem.taylor_terms, 20)

    psi = np.asarray(problem.initial_vectors_c, dtype=np.complex128).T  # [N,V]
    if problem.U_c is not None:
        Uc = np.asarray(problem.U_c, dtype=np.complex128)
        targets = Uc.T if problem.state_transfer else Uc @ psi          # [N,V]
    else:  # fall back to the float32 iso targets
        tv = np.asarray(problem.target_vectors, dtype=np.float64)
        targets = tv[:n, :] + 1j * tv[n: 2 * n, :]
    if not problem.state_transfer:
        # the device forward propagates from U0 (evolve_unitary starts its
        # chain at U0; final_vecs = final_U @ psi0) — apply it here too so
        # a non-identity U0 gives the same frame.  Targets are Uc @ psi0
        # WITHOUT U0, matching tensorflow_state.py:165 (target_vecs built
        # from U only).
        psi = np.asarray(problem.U0_c, dtype=np.complex128) @ psi

    for t in range(problem.steps):
        A = -1j * dt * (H0 + sum(u * H for u, H in zip(uks[:, t], Hops)))
        # scale so the series converges to ~1e-15 at `order` terms; the
        # Frobenius norm upper-bounds the spectral norm at O(N^2) cost
        # (an overestimated scaling exponent only adds cheap squarings —
        # the exact 2-norm was an O(N^3) SVD per step)
        s = max(0, int(np.ceil(np.log2(max(
            np.linalg.norm(A, "fro"), 1e-30)))))
        As = A / (2.0 ** s)
        for _ in range(2 ** s):
            term = psi
            acc = psi.copy()
            for k in range(1, order):
                term = (As @ term) / k
                acc += term
            psi = acc
    V = psi.shape[1]
    ov = np.sum(np.conj(targets) * psi)  # sum_v <t_v|psi_v>
    return float(np.abs(ov) ** 2 / (V * V))


def populations(problem: ControlProblem, inter_vecs: np.ndarray):
    """|psi|^2 per level over time, dressed-rotated when applicable
    (analysis.py:55-88).  Returns [V, N, T+1]."""
    vc = inter_vecs_to_complex(problem, inter_vecs)
    if problem.is_dressed:
        v_sorted = sort_ev(
            np.asarray(problem.dressed_info["eigenvectors"]),
            list(problem.dressed_info["dressed_id"]),
        )
        vc = np.einsum("ij,vjt->vit", np.transpose(v_sorted), vc)
    return np.square(np.abs(vc))


def append_metrics(
    file_path: str,
    *,
    error: float,
    reg_error: float,
    uks: np.ndarray,
    iteration: int,
    run_time: float,
    unitary_scale: float,
):
    """Per-update_step appends (run_session.py:129-137)."""
    from .h5 import H5File

    with H5File(file_path, "a") as hf:
        hf.append("error", np.array(error))
        hf.append("reg_error", np.array(reg_error))
        hf.append("uks", np.array(uks))
        hf.append("iteration", np.array(iteration))
        hf.append("run_time", np.array(run_time))
        hf.append("unitary_scale", np.array(unitary_scale))


def append_evolution(
    file_path: str,
    problem: ControlProblem,
    final_state: Optional[np.ndarray],
    inter_vecs: Optional[np.ndarray],
):
    """Evolution snapshots (analysis.py:31-33, :62-99)."""
    from .h5 import H5File

    with H5File(file_path, "a") as hf:
        if final_state is not None and not problem.state_transfer:
            hf.append("final_state", np.asarray(final_state))
        if inter_vecs is not None:
            vc = inter_vecs_to_complex(problem, inter_vecs)  # [V, N, T+1]
            hf.append("inter_vecs_raw_real", np.real(vc))
            hf.append("inter_vecs_raw_imag", np.imag(vc))
            pops = populations(problem, inter_vecs)
            hf.append("inter_vecs_mag_squared", pops)
            # dressed-rotated components (analysis.py:78-79, :98-99)
            vc_rot = vc
            if problem.is_dressed:
                v_sorted = sort_ev(
                    np.asarray(problem.dressed_info["eigenvectors"]),
                    list(problem.dressed_info["dressed_id"]),
                )
                vc_rot = np.einsum("ij,vjt->vit", np.transpose(v_sorted), vc)
            hf.append("inter_vecs_real", np.real(vc_rot))
            hf.append("inter_vecs_imag", np.imag(vc_rot))
