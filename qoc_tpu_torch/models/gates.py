"""Standard gate constructors and qudit-basis utilities (host-side numpy).

Parity targets: helper_functions/grape_functions.py:26-95 (qft, Hadamard,
transmon_gate, rz, rx, concerned, is_binary, Basis, Bin, baseN,
hamming_distance).
"""

from __future__ import annotations

import numpy as np


def qft(N: int) -> np.ndarray:
    """Quantum Fourier transform on N qubits (grape_functions.py:26-32)."""
    dim = 2 ** N
    phase = 2.0j * np.pi / dim
    L, M = np.meshgrid(np.arange(dim), np.arange(dim))
    return np.exp(phase * (L * M)) / np.sqrt(dim)


def hamming_distance(x: int) -> int:
    """Popcount (grape_functions.py:34-39)."""
    return int(bin(x).count("1"))


def hadamard(N: int = 1) -> np.ndarray:
    """N-qubit Hadamard (grape_functions.py:41-46)."""
    dim = 2 ** N
    return (2.0 ** (-N / 2.0)) * np.array(
        [[(-1) ** hamming_distance(i & j) for i in range(dim)] for j in range(dim)]
    )


# Reference-compatible alias
Hadamard = hadamard


def rz(theta: float) -> np.ndarray:
    return np.array([[np.exp(-1j * theta / 2), 0], [0, np.exp(1j * theta / 2)]])


def rx(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def base_n(num: int, b: int, numerals: str = "0123456789abcdefghijklmnopqrstuvwxyz") -> str:
    """Integer -> base-b string (grape_functions.py:88-89)."""
    if num == 0:
        return numerals[0]
    digits = []
    while num:
        digits.append(numerals[num % b])
        num //= b
    return "".join(reversed(digits))


def basis_string(a: int, N: int, r: int) -> str:
    """Zero-padded base-r representation of a on N digits (grape_functions.py:91-95)."""
    s = base_n(a, r)
    return s.rjust(N, "0")


def bin_string(a: int, N: int) -> str:
    """Zero-padded binary string (grape_functions.py:82-86)."""
    return np.binary_repr(a).rjust(N, "0")


def is_binary(num: str) -> bool:
    """True if the digit string only contains 0/1 (grape_functions.py:56-62)."""
    return all(c in "01" for c in num)


def concerned(N: int, levels: int):
    """Indices of computational (binary) states in an N-qudit register
    (grape_functions.py:48-54)."""
    return [i for i in range(levels ** N) if is_binary(basis_string(i, N, levels))]


def transmon_gate(gate: np.ndarray, levels: int) -> np.ndarray:
    """Embed an N-qubit gate into an N-qudit (``levels``-level) register,
    acting as identity outside the computational subspace
    (grape_functions.py:64-74)."""
    gate = np.asarray(gate)
    N = int(np.log2(len(gate)))
    dim = levels ** N
    result = np.identity(dim, dtype=complex)
    for i in range(dim):
        ib = basis_string(i, N, levels)
        if not is_binary(ib):
            continue
        for j in range(dim):
            jb = basis_string(j, N, levels)
            if is_binary(jb):
                result[i, j] = gate[int(ib, 2), int(jb, 2)]
    return result


# Reference-name aliases (grape_functions.py API surface)
baseN = base_n
Basis = basis_string
Bin = bin_string
