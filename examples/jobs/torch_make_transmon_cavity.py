"""Generate the BASELINE config-4 job spec with qoc_tpu_torch's front end:
transmon-cavity state transfer at dim 60 (3-level transmon x 20-level
cavity), dressed basis, bandpass + speed_up + dwdt costs.  The
counterpart of examples/jobs/make_transmon_cavity.py, with the same
constants, the same system and the same output bytes.

Physics: dispersive cQED in the frame rotating at the qubit frequency
(detunings instead of absolute frequencies keep |dt*H| inside the
Taylor-convergent range).  Task: prepare one cavity photon, the dressed
|g,1> from the dressed vacuum, with qubit x/y and cavity x/y drives.

``build_system`` and the constants are what examples/torch_04_
transmon_cavity.py and bench_torch.py build config 4 from.  Run as a
script, it writes transmon_cavity.npz (arrays) and transmon_cavity.json
(the spec, with npz references) into ``--out-dir``, a new temporary
directory by default: the committed files beside this script are never
overwritten unless ``--out-dir`` names their directory.

Run:  python examples/jobs/torch_make_transmon_cavity.py [--out-dir D]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import qoc_tpu_torch as q  # noqa: E402

QLEV, CLEV = 3, 20
DELTA_C = 2 * np.pi * 0.6      # cavity-qubit detuning (GHz)
ALPHA = -2 * np.pi * 0.2       # transmon anharmonicity
G = 2 * np.pi * 0.1            # J-C coupling
MAXA = 2 * np.pi * 0.3
TOTAL_TIME = 40.0              # ns
STEPS = 1000


def build_system():
    """(H0, Hops, Hnames): the dim-60 transmon-cavity Hamiltonian in the
    qubit rotating frame, with qubit and cavity x/y drives."""
    aq = q.annihilate(QLEV)
    ac = q.annihilate(CLEV)
    Iq = np.eye(QLEV)
    Ic = np.eye(CLEV)
    nc = np.kron(Iq, ac.conj().T @ ac)
    kerr = np.kron(aq.conj().T @ aq.conj().T @ aq @ aq, Ic)
    coup = np.kron(aq, Ic) @ np.kron(Iq, ac).conj().T
    coup = coup + coup.conj().T
    H0 = DELTA_C * nc + (ALPHA / 2) * kerr + G * coup
    drives = [
        np.kron(aq + aq.conj().T, Ic),
        np.kron(1j * (aq - aq.conj().T), Ic),
        np.kron(Iq, ac + ac.conj().T),
        np.kron(Iq, 1j * (ac - ac.conj().T)),
    ]
    return H0, drives, ["qx", "qy", "cx", "cy"]


def write_job(out_dir: str):
    """Write transmon_cavity.npz and transmon_cavity.json into
    ``out_dir``; returns their paths."""
    H0, Hops, Hnames = build_system()
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    psi0 = v_c[:, q.get_state_index(0, dressed_id)]
    target = v_c[:, q.get_state_index(1, dressed_id)]

    npz = os.path.join(out_dir, "transmon_cavity.npz")
    np.savez(
        npz, H0=H0, H1=Hops[0], H2=Hops[1], H3=Hops[2], H4=Hops[3],
        psi0=psi0, target=target, eigenvectors=v_c,
        eigenvalues=np.real(w_c),
    )

    def ref(key):
        return {"npz": "transmon_cavity.npz", "key": key}

    spec = {
        "_comment": (
            "BASELINE config 4: transmon-cavity state transfer, dim 60, "
            "dressed basis, bandpass + speed_up + dwdt "
            "(regularization_functions.py:47-95) at published scale"),
        "H0": ref("H0"),
        "Hops": [ref("H1"), ref("H2"), ref("H3"), ref("H4")],
        "Hnames": Hnames,
        "U": [ref("target")],
        "total_time": TOTAL_TIME,
        "steps": STEPS,
        "states_concerned_list": [ref("psi0")],
        "state_transfer": True,
        "dressed_info": {
            "eigenvectors": ref("eigenvectors"),
            "eigenvalues": ref("eigenvalues"),
            "dressed_id": [int(i) for i in dressed_id],
            "is_dressed": True,
        },
        "maxA": [MAXA] * 4,
        "seed": 0,
        "reg_coeffs": {
            "dwdt": 0.0001,
            "bandpass": 0.1, "band": [0.1, 10.0],
            "speed_up": 0.0001,
        },
        "convergence": {
            "rate": 0.02, "update_step": 100, "max_iterations": 5000,
            "conv_target": 1e-08, "learning_rate_decay": 2500,
            "min_grad": 1e-25,
        },
        "method": "Adam",
        "save": True,
        "show_plots": False,
    }
    out = os.path.join(out_dir, "transmon_cavity.json")
    with open(out, "w") as f:
        json.dump(spec, f, indent=1)
    return npz, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=None,
                    help="where to write (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="transmon_cavity_")
    os.makedirs(out_dir, exist_ok=True)
    npz, out = write_job(out_dir)
    print(f"wrote {npz}\nwrote {out} (dim {QLEV * CLEV})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
