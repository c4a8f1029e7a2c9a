"""The dim-200 multimode cavity (BASELINE config 5) from its
configuration file: a qubit times a ``cavity_levels``-level cavity in the
qubit's rotating frame, drift 2 pi (f_c n + g (a+ s- + a s+)), controls
qubit x, qubit y and the cavity drive a + a+, the state transfer |g,0> to
|e,0>, and the detuning delta n as one extra operator whose weight is the
seed's point of the grid (seed s at grid[s % grid])."""

import numpy as np


def build(cfg: dict) -> dict:
    nc = int(cfg["cavity_levels"])
    a = np.kron(np.eye(2), np.diag(np.sqrt(np.arange(1, nc)), 1))
    sm = np.kron(np.array([[0, 1], [0, 0]]), np.eye(nc))
    n_op = a.conj().T @ a
    H0 = (2 * np.pi * float(cfg["cavity_ghz"]) * n_op
          + 2 * np.pi * float(cfg["coupling_ghz"])
          * (a.conj().T @ sm + a @ sm.conj().T))
    psi0 = np.zeros(2 * nc, complex)
    psi0[0] = 1
    target = np.zeros(2 * nc, complex)
    target[nc] = 1
    lo, hi = cfg["detuning_range"]
    return {
        "H0": H0.astype(complex),
        "Hops": [(sm + sm.conj().T).astype(complex),
                 1j * (sm - sm.conj().T), (a + a.conj().T).astype(complex)],
        "Hnames": ["x", "y", "c"],
        "target": [target],
        "states": [psi0],
        "state_transfer": True,
        "total_time": float(cfg["total_time"]),
        "steps": int(cfg["steps"]),
        "maxA": [2 * np.pi * f for f in cfg["maxA_ghz"]],
        "reg_coeffs": dict(cfg["reg_coeffs"]),
        "extra_ops": [n_op.astype(complex)],
        "extra_grid": np.linspace(lo, hi, int(cfg["detuning_grid"])),
    }
