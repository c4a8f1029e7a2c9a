"""Command-line interface of the port: run, verify and plot optimizations
from job files (port of ``qoc_tpu.cli``).

    python -m qoc_tpu_torch run job.json              # optimize on the card
    python -m qoc_tpu_torch run job.json --device cpu # ... or on the CPU
    python -m qoc_tpu_torch verify RUN.h5 --atol 1e-4 # independent oracle
    python -m qoc_tpu_torch plot RUN.h5 --out dash.png

Job files are qoc_tpu's: a JSON object of ``Grape`` keyword arguments
(``utils.jobs``; ``load_config`` is its ``load_job``).  ``run`` takes the
CUDA card unless ``--device`` names another device, and exits non-zero
when torch sees no card; it never falls back to the CPU.  A run that
saves (the job's ``"save"``, true by default) writes an h5 file and needs
h5py, as ``verify`` and ``plot`` do; ``plot`` also needs matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .interop import entry_device
from .utils.jobs import load_job as load_config


def cmd_run(args) -> int:
    from .grape import Grape

    try:
        device = entry_device(args.device)
    except RuntimeError as e:
        print(f"qoc_tpu_torch run: {e}", file=sys.stderr)
        return 2
    cfg = load_config(args.config)
    cfg.setdefault("show_plots", False)
    if args.data_path:
        cfg["data_path"] = args.data_path
    if args.seed is not None:
        cfg["seed"] = args.seed
    if cfg.get("save", True):
        # default the run name to the job file's stem and the output
        # directory to the working directory
        cfg.setdefault("file_name",
                       os.path.splitext(os.path.basename(args.config))[0])
        cfg.setdefault("data_path", ".")
    res = Grape(**cfg, device=device)
    print(json.dumps({
        "loss": res.loss,
        "reg_loss": res.reg_loss,
        "iterations": res.iterations,
        "unitary_scale": res.unitary_scale,
        "file_path": res.file_path,
    }))
    return 0


def cmd_verify(args) -> int:
    from .utils.verification import verify_run

    out = verify_run(args.run_file, atol=args.atol, oracle=args.oracle)
    print(json.dumps(out))
    return 0 if all(out["all_close"]) else 1


def cmd_plot(args) -> int:
    """Render pulse + population panels straight from a saved run file."""
    import matplotlib

    matplotlib.use("Agg")
    import h5py
    import matplotlib.pyplot as plt

    with h5py.File(args.run_file, "r") as hf:
        uks = np.array(hf["uks"])[-1]
        total_time = float(np.array(hf["total_time"]))
        steps = int(np.array(hf["steps"]))
        error = np.array(hf["error"]) if "error" in hf else None
        pops = (
            np.array(hf["inter_vecs_mag_squared"])[-1]
            if "inter_vecs_mag_squared" in hf else None
        )
    dt = total_time / steps
    n_panels = 1 + (error is not None) + (pops is not None)
    fig, axes = plt.subplots(n_panels, 1, figsize=(12, 4 * n_panels))
    axes = np.atleast_1d(axes)
    i = 0
    if error is not None:
        axes[i].plot(error, "bx-")
        axes[i].set_yscale("log")
        axes[i].set_title("Fidelity error")
        i += 1
    ts = dt * np.arange(uks.shape[1])
    for k in range(uks.shape[0]):
        axes[i].plot(ts, uks[k], label=f"u{k}")
    axes[i].set_title("Optimized pulse")
    axes[i].legend()
    i += 1
    if pops is not None:
        for lvl in range(min(pops.shape[1], 5)):
            axes[i].plot(dt * np.arange(pops.shape[2]), pops[0, lvl],
                         label=f"level {lvl}")
        axes[i].set_title("Populations (first initial state)")
        axes[i].legend()
    fig.tight_layout()
    fig.savefig(args.out, dpi=100)
    plt.close(fig)
    print(args.out)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="qoc_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="optimize from a JSON job spec")
    p_run.add_argument("config")
    p_run.add_argument("--data-path", default=None)
    p_run.add_argument("--seed", type=int, default=None)
    p_run.add_argument("--device", default=None,
                       help="torch device of the run (default: the CUDA "
                            "card; 'cpu' runs the plain torch versions)")
    p_run.set_defaults(fn=cmd_run)

    p_ver = sub.add_parser("verify", help="independent-oracle verification")
    p_ver.add_argument("run_file")
    p_ver.add_argument("--atol", type=float, default=1e-4)
    p_ver.add_argument("--oracle",
                       choices=["scipy", "ode", "qutip", "qutip-shim"],
                       default="scipy")
    p_ver.set_defaults(fn=cmd_verify)

    p_plot = sub.add_parser("plot", help="render dashboard from a run file")
    p_plot.add_argument("run_file")
    p_plot.add_argument("--out", default="dashboard.png")
    p_plot.set_defaults(fn=cmd_plot)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
