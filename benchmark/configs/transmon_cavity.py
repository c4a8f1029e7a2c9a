"""The dim-60 transmon-cavity state transfer (BASELINE config 4) from its
configuration file: a ``transmon_levels``-level transmon times a
``cavity_levels``-level cavity in the qubit's rotating frame, drift
2 pi (delta_c n_c + (alpha / 2) a+a+aa + g (a c+ + a+ c)), drives qubit
x, qubit y, cavity x and cavity y, and the state transfer from the
dressed state of ``initial_bare_state`` to that of
``target_bare_state`` (the dressed vacuum to the dressed |g,1>).

The dressed basis is found as the upstream ``get_dressed_info`` finds
it: the eigenvectors of H0, each assigned to the bare state it overlaps
most; it goes to ``Grape`` as ``dressed_info``."""

import numpy as np


def _lower(levels: int) -> np.ndarray:
    return np.diag(np.sqrt(np.arange(1, levels)), 1).astype(complex)


def dressed_info(H0: np.ndarray):
    """(eigenvalues, eigenvectors, dressed_id): dressed_id[i] is the bare
    state that eigenvector i overlaps most, the next most where that one
    is taken (upstream ``grape_functions.py:9-24``)."""
    w, v = np.linalg.eig(H0)
    dressed_id = []
    for i in range(len(v)):
        mag = np.abs(v[:, i]).tolist()
        index = int(np.argmax(mag))
        while index in dressed_id:
            mag[index] = 0
            index = int(np.argmax(mag))
        dressed_id.append(index)
    return w, v, dressed_id


def build(cfg: dict) -> dict:
    nq, nc = int(cfg["transmon_levels"]), int(cfg["cavity_levels"])
    aq, ac = _lower(nq), _lower(nc)
    Iq, Ic = np.eye(nq), np.eye(nc)
    n_c = np.kron(Iq, ac.conj().T @ ac)
    kerr = np.kron(aq.conj().T @ aq.conj().T @ aq @ aq, Ic)
    coup = np.kron(aq, Ic) @ np.kron(Iq, ac).conj().T
    coup = coup + coup.conj().T
    H0 = (2 * np.pi * float(cfg["cavity_detuning_ghz"]) * n_c
          + (2 * np.pi * float(cfg["anharmonicity_ghz"]) / 2) * kerr
          + 2 * np.pi * float(cfg["coupling_ghz"]) * coup)
    w, v, dressed_id = dressed_info(H0)
    psi0 = v[:, dressed_id.index(int(cfg["initial_bare_state"]))]
    target = v[:, dressed_id.index(int(cfg["target_bare_state"]))]
    return {
        "H0": H0,
        "Hops": [np.kron(aq + aq.conj().T, Ic),
                 np.kron(1j * (aq - aq.conj().T), Ic),
                 np.kron(Iq, ac + ac.conj().T),
                 np.kron(Iq, 1j * (ac - ac.conj().T))],
        "Hnames": ["qx", "qy", "cx", "cy"],
        "target": [target],
        "states": [psi0],
        "state_transfer": True,
        "total_time": float(cfg["total_time"]),
        "steps": int(cfg["steps"]),
        "maxA": [2 * np.pi * f for f in cfg["maxA_ghz"]],
        "reg_coeffs": dict(cfg["reg_coeffs"]),
        "grape_kwargs": {"dressed_info": {
            "eigenvectors": v, "eigenvalues": np.real(w),
            "dressed_id": dressed_id, "is_dressed": True}},
    }
