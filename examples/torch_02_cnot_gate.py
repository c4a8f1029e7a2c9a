"""Two-qubit CNOT gate (BASELINE config 2) on qoc_tpu_torch: the port of
examples/02_cnot_gate.py.

Unitary-mode GRAPE: 4x4 target, four control Hamiltonians, smoothness +
envelope regularizers.  ``Grape`` gets the original's problem,
reg_coeffs, convergence, maxA and seed; on the card it routes to the
fused Adam segment kernel's costs instance (kernel 3,
``mega_segment_costs``).  It prints the original's line, then one JSON
line (``torch_example_run``).

Run:  python examples/torch_02_cnot_gate.py [--device cpu]
          [--max-iterations N]
"""

import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

import qoc_tpu_torch as q  # noqa: E402
import torch_example_run as run  # noqa: E402


def main(device=None, max_iterations=None):
    I2 = np.eye(2)
    H0 = np.zeros((4, 4), dtype=complex)
    Hops = [
        np.kron(q.SIGMA_X, I2),      # X on qubit 1
        np.kron(I2, q.SIGMA_X),      # X on qubit 2
        np.kron(q.SIGMA_Y, I2),      # Y on qubit 1
        np.kron(q.SIGMA_X, q.SIGMA_X),  # XX coupling
    ]
    Hnames = ["xi", "ix", "yi", "xx"]
    CNOT = np.eye(4)[:, [0, 1, 3, 2]].astype(complex)

    (uks, Uf), summary = run.grape(
        "02_cnot_gate", device, max_iterations,
        H0, Hops, Hnames, CNOT, 12.0, 600, [0, 1, 2, 3],
        reg_coeffs={"dwdt": 0.001, "envelope": 0.0001},
        convergence={"rate": 0.02, "update_step": 100,
                     "max_iterations": 5000, "conv_target": 1e-6},
        maxA=[1.0] * 4,
        seed=0,
        method="Adam",
        show_plots=False,
        save=False,
    )
    fid = np.abs(np.trace(CNOT.conj().T @ Uf)) / 4
    print(f"CNOT trace fidelity: {fid:.6f}")
    run.report(summary)
    return summary


if __name__ == "__main__":
    sys.exit(run.cli(main, __doc__))
