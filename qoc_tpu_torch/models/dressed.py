"""Dressed-state (eigenbasis) bookkeeping (host-side numpy).

Parity targets: grape_functions.py:4-24 (dressed_unitary, get_dressed_info)
and :194-209 (sort_ev, get_state_index).  The dressed subsystem is
cross-cutting in the reference: initial vectors (system_parameters.py:178),
forbidden-state basis rotation (regularization_functions.py:73-80), and
population readout (analysis.py:55-79).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as la


def get_dressed_info(H0: np.ndarray):
    """Eigendecompose H0 and assign each dressed state to the bare state it
    overlaps most (grape_functions.py:9-24).  Returns (w_c, v_c, dressed_id).
    """
    w_c, v_c = la.eig(np.asarray(H0, dtype=complex))
    dressed_id: list[int] = []
    for ii in range(len(v_c)):
        index = int(np.argmax(np.abs(v_c[:, ii])))
        if index not in dressed_id:
            dressed_id.append(index)
        else:
            temp = np.abs(v_c[:, ii]).tolist()
            while index in dressed_id:
                temp[index] = 0
                index = int(np.argmax(temp))
            dressed_id.append(index)
    return w_c, v_c, dressed_id


def get_state_index(bare_index: int, dressed_id) -> int:
    """Index of the dressed state with max overlap with a bare state
    (grape_functions.py:204-209)."""
    if len(dressed_id) > 0:
        return dressed_id.index(bare_index)
    return bare_index


def sort_ev(v: np.ndarray, dressed_id) -> np.ndarray:
    """Sort eigenvector columns into bare-state order (grape_functions.py:194-202)."""
    n = len(dressed_id)
    v_sorted = [v[:, get_state_index(ii, dressed_id)] for ii in range(n)]
    return np.transpose(np.reshape(v_sorted, [n, n]))


def dressed_unitary(U: np.ndarray, v: np.ndarray, dressed_id) -> np.ndarray:
    """Rotate a unitary into the dressed basis (grape_functions.py:4-7)."""
    conversion_U = sort_ev(v, dressed_id)
    return conversion_U @ U @ conversion_U.conj().T
