"""Complex <-> real isomorphism used throughout the framework (numpy copy
of ``qoc_tpu.ops.isomorphism``; the port keeps no traced variants).

A complex matrix ``M`` is represented by the real matrix

    iso(M) = [[Re M, -Im M],
              [Im M,  Re M]]

and a complex vector ``v`` by ``[Re v; Im v]``.  ``iso`` is a *-algebra
homomorphism: ``iso(AB) = iso(A) iso(B)`` and ``iso(A)^T = iso(A^dagger)``,
so unitary propagation can run entirely in real float32 arithmetic.

Reference parity: quantum_optimal_control/helper_functions/grape_functions.py:211-220
(`c_to_r_mat`, `c_to_r_vec`) and core/analysis.py:18-24 (`RtoCMat`).
"""

from __future__ import annotations

import numpy as np


def c_to_r_mat(M) -> np.ndarray:
    """Complex-to-real isomorphism for a matrix (host-side numpy)."""
    M = np.asarray(M, dtype=complex)
    return np.block([[M.real, -M.imag], [M.imag, M.real]])


def c_to_r_vec(V) -> np.ndarray:
    """Complex-to-real isomorphism for a vector: [Re v; Im v]."""
    V = np.asarray(V, dtype=complex)
    return np.concatenate([V.real, V.imag])


def r_to_c_mat(M) -> np.ndarray:
    """Inverse isomorphism for matrices: read the [Re; Im] left block column.

    Mirrors Analysis.RtoCMat (analysis.py:18-24).
    """
    M = np.asarray(M)
    n = M.shape[-2] // 2
    return M[..., :n, :n] + 1j * M[..., n : 2 * n, :n]


def r_to_c_vec(V) -> np.ndarray:
    """Inverse isomorphism for vectors."""
    V = np.asarray(V)
    n = V.shape[0] // 2
    return V[:n] + 1j * V[n : 2 * n]
