"""Transmon with leakage (BASELINE config 3) on qoc_tpu_torch: the port
of examples/03_transmon_leakage.py.

5-level qudit X gate: anharmonic drift, x/y drives, forbidden-state cost
on levels 2-4 to suppress leakage out of the computational subspace.
``Grape`` gets the original's problem, reg_coeffs, convergence, maxA and
seed; on the card it routes to the fused Adam segment kernel's costs
instance (kernel 3, ``mega_segment_costs``).  It prints the original's
line, then one JSON line (``torch_example_run``).

Run:  python examples/torch_03_transmon_leakage.py [--device cpu]
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
    levels = 5
    anharmonicity = -0.2 * 2 * np.pi  # GHz, transmon-like

    a = q.annihilate(levels)
    ad = a.conj().T
    H0 = (anharmonicity / 2) * (ad @ ad @ a @ a)
    Hops = [a + ad, 1j * (a - ad)]
    Hnames = ["x", "y"]
    X_gate = q.transmon_gate(q.SIGMA_X, levels)

    (uks, Uf), summary = run.grape(
        "03_transmon_leakage", device, max_iterations,
        H0, Hops, Hnames, X_gate, 6.0, 300, [0, 1],
        reg_coeffs={
            "forbidden_coeff_list": [10.0, 10.0, 10.0],
            "states_forbidden_list": [2, 3, 4],
            "dwdt": 0.001,
        },
        convergence={"rate": 0.02, "update_step": 100,
                     "max_iterations": 5000, "conv_target": 1e-6},
        maxA=[2.0, 2.0],
        seed=0,
        method="Adam",
        show_plots=False,
        save=False,
    )
    comp = [0, 1]
    fid = np.abs(np.trace(
        X_gate[np.ix_(comp, comp)].conj().T @ Uf[np.ix_(comp, comp)])) / 2
    print(f"computational-subspace fidelity: {fid:.6f}")
    run.report(summary)
    return summary


if __name__ == "__main__":
    sys.exit(run.cli(main, __doc__))
