"""Spin-1/2 qubit pi pulse (BASELINE config 1) on qoc_tpu_torch: the port
of examples/01_qubit_pi_pulse.py.

State transfer |0> -> |1> with sigma_x / sigma_y drives, the minimal
end-to-end GRAPE problem.  ``Grape`` gets the original's problem,
convergence, maxA and seed; on the card it routes to the fused Adam
segment kernel (kernel 3, ``mega_segment``).  It prints the original's
line, then one JSON line (``torch_example_run``).

Run:  python examples/torch_01_qubit_pi_pulse.py [--device cpu]
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
    H0 = np.zeros((2, 2), dtype=complex)
    Hops = [q.SIGMA_X, q.SIGMA_Y]
    Hnames = ["x", "y"]

    psi0 = [np.array([1, 0], dtype=complex)]   # start in |0>
    target = [np.array([0, 1], dtype=complex)]  # end in |1>

    total_time = 10.0   # ns (freq_unit GHz)
    steps = 1000

    (uks, Uf), summary = run.grape(
        "01_qubit_pi_pulse", device, max_iterations,
        H0, Hops, Hnames, target, total_time, steps, psi0,
        state_transfer=True,
        convergence={"rate": 0.01, "update_step": 100,
                     "max_iterations": 5000, "conv_target": 1e-8},
        maxA=[2 * np.pi * 0.1] * 2,
        seed=0,
        method="Adam",
        show_plots=False,
        save=False,
    )
    print("optimized pulse shape:", np.shape(uks))
    run.report(summary)
    return summary


if __name__ == "__main__":
    sys.exit(run.cli(main, __doc__))
