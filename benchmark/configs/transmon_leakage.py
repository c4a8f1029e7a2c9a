"""The transmon-leakage gate (BASELINE config 3) from its configuration
file: a ``levels``-level transmon with the Kerr drift (alpha / 2) a+a+aa,
x and y drives a + a+ and i (a - a+), and the X gate on levels 0-1,
identity on the levels above (upstream ``transmon_gate``)."""

import numpy as np


def build(cfg: dict) -> dict:
    n = int(cfg["levels"])
    a = np.diag(np.sqrt(np.arange(1, n)), 1).astype(complex)
    ad = a.conj().T
    alpha = 2 * np.pi * float(cfg["anharmonicity_ghz"])
    gates = {"x": np.array([[0, 1], [1, 0]], dtype=complex)}
    target = np.eye(n, dtype=complex)
    target[:2, :2] = gates[cfg["gate"]]
    return {
        "H0": (alpha / 2) * (ad @ ad @ a @ a),
        "Hops": [a + ad, 1j * (a - ad)],
        "Hnames": ["x", "y"],
        "target": target,
        "states": list(cfg["states_concerned"]),
        "state_transfer": False,
        "total_time": float(cfg["total_time"]),
        "steps": int(cfg["steps"]),
        "maxA": list(cfg["maxA"]),
        "reg_coeffs": dict(cfg["reg_coeffs"]),
    }
