"""Multi-qubit/qudit tensor-product operator builders (host-side numpy).

Parity targets: grape_functions.py:98-191 (kron_all, multi_kron,
append_separate_krons, nn_chain_kron), plus standard ladder/Pauli helpers
the reference examples build by hand.
"""

from __future__ import annotations

import numpy as np


def kron_all(op: np.ndarray, num: int, op_2: np.ndarray) -> np.ndarray:
    """Sum of single-site operators: op x I x ... + I x op x ... + ...

    Note the reference's implementation (grape_functions.py:98-116) contains
    a bug — it returns only the *last* term ``a`` instead of the accumulated
    ``total``.  We implement the documented intent (the docstring "returns an
    addition of sth like xii + ixi + iix") and expose the buggy behavior via
    ``kron_all_reference`` for anyone reproducing old runs.
    """
    total = np.zeros((len(op) ** num, len(op) ** num), dtype=np.result_type(op, op_2))
    for site in range(num):
        a = op if site == 0 else op_2
        for k in range(1, num):
            a = np.kron(a, op if k == site else op_2)
        total = total + a
    return total


def kron_all_reference(op: np.ndarray, num: int, op_2: np.ndarray) -> np.ndarray:
    """Bit-compatible replica of the reference kron_all (returns last term)."""
    a = op
    for jj in range(num):
        a = op if jj == 0 else op_2
        for ii in range(num - 1):
            b = op if (jj - ii) == 1 else op_2
            a = np.kron(a, b)
    return a


def multi_kron(op: np.ndarray, num: int) -> np.ndarray:
    """op x op x ... x op, num times (grape_functions.py:118-123)."""
    a = op
    for _ in range(num - 1):
        a = np.kron(a, op)
    return a


def append_separate_krons(op, name, num, state_num, Hops, Hnames, ops_max_amp, amp=4.0):
    """Append xii, ixi, iix (etc.) as separate control ops
    (grape_functions.py:125-163)."""
    I_q = np.identity(state_num)
    for site in range(num):
        X1 = op if site == 0 else I_q
        label = name if site == 0 else "i"
        for k in range(1, num):
            X1 = np.kron(X1, op if k == site else I_q)
            label += name if k == site else "i"
        Hops.append(X1)
        ops_max_amp.append(amp)
        Hnames.append(label)
    return Hops, Hnames, ops_max_amp


def nn_chain_kron(op, op_I, qubit_num, qubit_state_num) -> np.ndarray:
    """Nearest-neighbour coupling chain: xxii + ixxi + iixx
    (grape_functions.py:165-191)."""
    dim = qubit_state_num ** qubit_num
    total = np.zeros((dim, dim), dtype=np.result_type(op, op_I))
    for site in range(qubit_num - 1):
        a = op if site == 0 else op_I
        for k in range(1, qubit_num):
            a = np.kron(a, op if k in (site, site + 1) else op_I)
        total = total + a
    return total


# ---- Standard building blocks (new convenience surface) -------------------


def annihilate(levels: int) -> np.ndarray:
    """Qudit lowering operator a."""
    return np.diag(np.sqrt(np.arange(1, levels)), 1).astype(complex)


def create(levels: int) -> np.ndarray:
    """Qudit raising operator a^dagger."""
    return annihilate(levels).conj().T


def number(levels: int) -> np.ndarray:
    return np.diag(np.arange(levels)).astype(complex)


SIGMA_X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype=complex)
SIGMA_Y = np.array([[0.0, -1.0j], [1.0j, 0.0]], dtype=complex)
SIGMA_Z = np.array([[1.0, 0.0], [0.0, -1.0]], dtype=complex)
SIGMA_P = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
SIGMA_M = np.array([[0.0, 0.0], [1.0, 0.0]], dtype=complex)
