"""The Taylor order and the number of squarings of the reference GRAPE
method (the upstream pre-pass, system_parameters.py:88-158 and
:208-230), from the problem's matrices: the work counts take the number
of series terms and squarings from here, not from the program."""

import numpy as np


def _approx_expm(M, order, scaling):
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


def _approx_exp(x, order, scaling):
    U, Mt, factorial = 1.0, 1.0, 1.0
    for n in range(1, order):
        factorial *= n
        Mt = x * Mt
        U = U + Mt / ((2.0 ** float(n * scaling)) * factorial)
    for _ in range(scaling):
        U = U * U
    return U


def taylor_terms(H0, Hops, maxA, dt, steps, state_transfer,
                 unitary_error=1e-4):
    """(terms, squarings) as the upstream pre-pass picks them, with the
    identity as the initial unitary; its quirks (the scaling increments
    that accumulate over the candidates, the trial unitary that is never
    reset below dim 10) are kept, since they set the order."""
    N = len(H0)
    H = np.asarray(H0, dtype=complex)
    for amp, op in zip(maxA, Hops):
        H = H + amp * np.asarray(op, dtype=complex)
    scaling, exps, scalings = 0, [], []
    comparisons = 1 if state_transfer else 6
    d = 0
    while comparisons > 0:
        exp_t = 20
        U_f = np.identity(N, dtype=complex)
        if d == 0:
            scaling = max(int(2 * np.log2(np.max(np.abs(-1j * dt * H)))), 0)
        else:
            scaling += d
        if state_transfer:
            scaling = 0
        while True:
            if N < 10:
                step_U = _approx_expm(-1j * dt * H, exp_t, scaling)
                for _ in range(steps):
                    U_f = np.dot(U_f, step_U)
                metric = np.abs(np.trace(U_f.conj().T @ U_f)) / N
            else:
                x = np.max(np.abs(-1j * dt * H))
                metric = 1 + steps * np.abs(
                    (_approx_exp(x, exp_t, scaling) - np.exp(x)) / np.exp(x))
            if exp_t == 3 or np.abs(metric - 1.0) >= unitary_error:
                break
            exp_t -= 1
        exps.append(exp_t)
        scalings.append(scaling)
        comparisons -= 1
        d += 1
    a = int(np.argmin(np.add(exps, scalings)))
    return int(exps[a]), int(scalings[a])
