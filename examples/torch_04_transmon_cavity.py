"""Transmon-cavity state transfer (BASELINE config 4) at dim 60 on
qoc_tpu_torch: the port of examples/04_transmon_cavity.py.

Dispersive cQED in the qubit rotating frame: a 3-level transmon coupled
to a 20-level cavity, dressed (eigen)basis bookkeeping, qubit x/y +
cavity x/y drives, and the trajectory-reading costs, bandpass + speed_up
+ dwdt.  Prepares one cavity photon: dressed |g,1> from the dressed
vacuum.  ``Grape`` gets the original's problem, reg_coeffs, convergence,
maxA and seed; on the card (M = 120) it routes to the pscan engine over
the batched Taylor kernel (kernel 7, ``expm_forward``).  It prints the
original's lines, then one JSON line (``torch_example_run``).

The full-scale job spec lives at examples/jobs/transmon_cavity.json
(regenerate with examples/jobs/torch_make_transmon_cavity.py); this
script runs the same system with a shorter iteration budget.

Run:  python examples/torch_04_transmon_cavity.py [--device cpu]
          [--max-iterations N]
"""

import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.join(_HERE, "jobs"))

import qoc_tpu_torch as q  # noqa: E402
import torch_example_run as run  # noqa: E402
from torch_make_transmon_cavity import (  # noqa: E402
    MAXA, STEPS, TOTAL_TIME, build_system)


def main(device=None, max_iterations=None):
    H0, Hops, Hnames = build_system()
    dim = len(H0)
    print("dim:", dim)

    # dressed-state bookkeeping (grape_functions.py:9-24 semantics)
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    dressed_info = {
        "eigenvectors": v_c,
        "eigenvalues": np.real(w_c),
        "dressed_id": dressed_id,
        "is_dressed": True,
    }
    psi0 = v_c[:, q.get_state_index(0, dressed_id)]
    target = v_c[:, q.get_state_index(1, dressed_id)]

    (uks, Uf), summary = run.grape(
        "04_transmon_cavity", device, max_iterations,
        H0, Hops, Hnames, [target], TOTAL_TIME, STEPS, [psi0],
        state_transfer=True,
        dressed_info=dressed_info,
        reg_coeffs={
            "dwdt": 0.0001,
            "bandpass": 0.1, "band": [0.1, 10.0],
            "speed_up": 0.0001,
        },
        convergence={"rate": 0.02, "update_step": 200,
                     "max_iterations": 2000, "conv_target": 1e-5},
        maxA=[MAXA] * 4,
        seed=0,
        method="Adam",
        show_plots=False,
        save=False,
    )
    print("pulse shape:", np.shape(uks))
    run.report(summary)
    return summary


if __name__ == "__main__":
    sys.exit(run.cli(main, __doc__))
