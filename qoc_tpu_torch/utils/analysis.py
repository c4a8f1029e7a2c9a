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
import torch

from ..models.dressed import sort_ev
from ..models.system import ControlProblem
from ..ops.isomorphism import r_to_c_mat
from .profiling import span


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


# The card path works over chunks of steps so that one [chunk, N, N]
# complex128 buffer stays under this many bytes (config 5's 200 steps at
# N = 200 take 128 MiB: one chunk).
_CHUNK_BYTES = 256 << 20


def fidelity_f64(problem: ControlProblem, uks: np.ndarray,
                 order: Optional[int] = None, device=None) -> float:
    """Final fidelity recomputed in float64 by the framework's OWN Taylor
    propagation (complex128) — the optimizer's algorithm class, freed of
    its float32 accumulation noise.

    The on-device forward runs float32: over ~1000 steps at Hilbert dims
    >= 50 the reported fidelity carries an irreducible ~1e-5 rounding
    floor (measured: config 4's f32 recompute is identical at Taylor
    order 15 and 20, so truncation contributes nothing — the gap to the
    float64 oracles is pure f32 accumulation).  This readout removes the
    representation noise so the BASELINE "fidelity delta < 1e-6 vs an
    independent oracle" criterion compares *algorithms* (Taylor vs Pade
    vs adaptive ODE), not float widths.  It is reported alongside — not
    instead of — the optimizer's own float32 loss.

    ``device=None`` runs the numpy host loop: per step, 2^s x (order - 1)
    [N,N]@[N,V] complex products, s the step's scaling exponent, so a
    Python loop of T x 2^s x (order - 1) products.  A torch ``device`` runs
    the same polynomial, scaling and squaring there as batched complex128
    matrices (``_fidelity_f64_batched``): O(order + max s + log T) launches
    and one copy of the step norms and of the final vectors to the host.
    The two agree to float64 rounding.  On an H100 80GB HBM3 and its host:
    config 5 (T = 200, N = 200, s = 4, order 20: ~61,000 products) 1.1-1.2 s
    in the host loop, 12 ms on the card; config 3 (T = 300, N = 5, s = 0)
    28-34 ms and 2.3 ms.
    """
    if order is None:
        order = max(problem.taylor_terms, 20)
    if device is not None:
        with span("qoc.analysis.fidelity_f64_card"):
            return _fidelity_f64_batched(problem, uks, order,
                                         torch.device(device))
    dt = problem.dt
    H0 = np.asarray(problem.H0_c, dtype=np.complex128)
    Hops = [np.asarray(h, dtype=np.complex128) for h in problem.ops_c]
    uks = np.asarray(uks, dtype=np.float64)
    psi, targets = _start_and_targets(problem)

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
    return _overlap(psi, targets)


def _start_and_targets(problem: ControlProblem):
    """(psi [N, V], targets [N, V]) in complex128: the columns the chain
    starts from, and what they are held against at its end."""
    n = problem.state_num
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
    return psi, targets


def _overlap(psi: np.ndarray, targets: np.ndarray) -> float:
    """|sum_v <t_v|psi_v>|^2 / V^2."""
    V = psi.shape[1]
    ov = np.sum(np.conj(targets) * psi)  # sum_v <t_v|psi_v>
    return float(np.abs(ov) ** 2 / (V * V))


def _fidelity_f64_batched(problem: ControlProblem, uks, order: int,
                          device: torch.device) -> float:
    """``fidelity_f64``'s host loop as batched complex128 matrices on
    ``device``, chunk by chunk of steps: the generators A_t of every step
    at once, the step propagators p(A_t / 2^s_t)^(2^s_t) (p the same
    degree order - 1 Taylor polynomial, by Horner; s_t by the host's rule
    from norms computed here), their ordered product by a pairwise tree,
    and that product applied to the chunk's incoming vectors.  No float32
    or TF32 anywhere."""
    def put(x, dtype=torch.complex128):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)

    n, steps = problem.state_num, problem.steps
    psi0, targets = _start_and_targets(problem)
    H0 = put(problem.H0_c)
    Hops = put(np.stack(problem.ops_c))                            # [K,N,N]
    u = put(np.asarray(uks, dtype=np.float64))                     # [K,T]
    psi = put(psi0)                                                # [N,V]
    eye = torch.eye(n, dtype=torch.complex128, device=device)
    chunk = max(1, _CHUNK_BYTES // (16 * n * n))
    for t0 in range(0, steps, chunk):
        A = (-1j * problem.dt) * (
            H0 + torch.einsum("kt,kij->tij", u[:, t0:t0 + chunk], Hops))
        s = np.ceil(np.log2(np.maximum(
            torch.linalg.matrix_norm(A).cpu().numpy(), 1e-30)))
        s = np.maximum(s, 0).astype(np.int64)                      # [c]
        X = A * put(2.0 ** -s, torch.float64)[:, None, None]
        del A
        # Horner from the top: P <- I + X P / k, k = order-1 .. 1
        P = eye.expand_as(X)
        for k in range(order - 1, 0, -1):
            P = torch.baddbmm(eye, X, P, alpha=1.0 / k)
        del X
        # squaring j applies to the steps with s_t > j
        s_dev = put(s, torch.int64)[:, None, None]
        for j in range(int(s.max())):
            P = torch.where(s_dev > j, torch.bmm(P, P), P)
        # ordered product P_{c-1} ... P_0; an odd last factor waits a level
        while P.shape[0] > 1:
            m = P.shape[0] // 2 * 2
            pairs = torch.bmm(P[1:m:2], P[0:m:2])
            P = torch.cat([pairs, P[m:]]) if m < P.shape[0] else pairs
        psi = P[0] @ psi
    return _overlap(psi.cpu().numpy(), targets)


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
