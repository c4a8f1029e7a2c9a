"""Host-side auto-selection of Taylor order and scaling/squaring count.

Faithful reimplementation of the reference's pre-pass
(system_parameters.py:88-158 `approx_expm`/`approx_exp`/`Choose_exp_terms`
and :208-230 selection loop), because the chosen (order, scaling) pair
changes the compiled compute function and therefore must match for parity
(SURVEY.md section 7, hard part 5).  All documented quirks are reproduced:

  * the scaling seed ``max(int(2*log2(max|-i*dt*H_max|)), 0)`` and the
    *cumulative* ``scaling += d`` increments across candidates
    (system_parameters.py:133-136);
  * the accumulating ``U_f`` across trial orders for dim < 10
    (system_parameters.py:140-145 — U_f is never reset inside the loop);
  * the scalar bound metric for dim >= 10 (system_parameters.py:146-149);
  * ``state_transfer`` / ``no_scaling`` forcing scaling = 0 and a single
    candidate (system_parameters.py:138-139, :211-214).
"""

from __future__ import annotations

import numpy as np


def approx_expm(M: np.ndarray, order: int, scaling: int) -> np.ndarray:
    """Taylor-approximated expm with scaling/squaring (numpy, host-side)."""
    U = np.identity(len(M), dtype=M.dtype)
    Mt = np.identity(len(M), dtype=M.dtype)
    factorial = 1.0
    for n in range(1, order):
        factorial *= n
        Mt = np.dot(Mt, M)
        U = U + Mt / ((2.0 ** float(n * scaling)) * factorial)
    for _ in range(scaling):
        U = np.dot(U, U)
    return U


def approx_exp(x: complex, order: int, scaling: int) -> complex:
    """Scalar analog of approx_expm (system_parameters.py:105-120)."""
    U = 1.0
    Mt = 1.0
    factorial = 1.0
    for n in range(1, order):
        factorial *= n
        Mt = x * Mt
        U = U + Mt / ((2.0 ** float(n * scaling)) * factorial)
    for _ in range(scaling):
        U = U * U
    return U


def choose_taylor_terms(
    H0_c: np.ndarray,
    ops_c,
    ops_max_amp,
    U0_c: np.ndarray,
    dt: float,
    steps: int,
    unitary_error: float,
    state_transfer: bool,
    no_scaling: bool,
):
    """Pick (taylor_order, scaling) minimizing order + scaling.

    Returns ``(exp_terms, scaling)`` exactly as the reference's
    init_operators selection (system_parameters.py:208-230).
    """
    state_num = len(H0_c)
    H = np.asarray(H0_c, dtype=complex)
    for amp, op in zip(ops_max_amp, ops_c):
        H = H + amp * np.asarray(op, dtype=complex)

    scaling = 0
    exps, scalings = [], []
    comparisons = 1 if (state_transfer or no_scaling) else 6
    d = 0
    while comparisons > 0:
        # -- Choose_exp_terms(d) (system_parameters.py:122-158) ------------
        exp_t = 20
        U_f = np.asarray(U0_c, dtype=complex)
        if d == 0:
            scaling = max(int(2 * np.log2(np.max(np.abs(-1j * dt * H)))), 0)
        else:
            scaling += d
        if state_transfer or no_scaling:
            scaling = 0
        while True:
            if state_num < 10:
                step_U = approx_expm(-1j * dt * H, exp_t, scaling)
                for _ in range(steps):
                    U_f = np.dot(U_f, step_U)
                metric = np.abs(np.trace(np.dot(np.conjugate(U_f.T), U_f))) / state_num
            else:
                max_term = np.max(np.abs(-1j * dt * H))
                metric = 1 + steps * np.abs(
                    (approx_exp(max_term, exp_t, scaling) - np.exp(max_term))
                    / np.exp(max_term)
                )
            if exp_t == 3:
                break
            if np.abs(metric - 1.0) < unitary_error:
                exp_t = exp_t - 1
            else:
                break
        # ------------------------------------------------------------------
        exps.append(exp_t)
        scalings.append(scaling)
        comparisons -= 1
        d += 1

    complexities = np.add(exps, scalings)
    a = int(np.argmin(complexities))
    return int(exps[a]), int(scalings[a])
