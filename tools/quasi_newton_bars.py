"""The quasi-Newton runs of chip_smoke.py's phase 9a, on the CPU, for either
package, and the float32 readout floor of the port's engines.

    JAX_PLATFORMS=cpu python3 tools/quasi_newton_bars.py --package qoc_tpu
    python3 tools/quasi_newton_bars.py --package port [--device cpu]
    python3 tools/quasi_newton_bars.py --package port --floor

Each run is ``Grape`` on examples/jobs/spin_pi.json (the native L-BFGS,
L-BFGS-B, BFGS) or examples/jobs/cnot.json (the native L-BFGS,
L-BFGS-B), T = 1000, the job's convergence with ``--conv-target``
(default 1e-5, phase 9a's), and prints one line ``run {...}``: 1 - loss,
the float64 readout's gap |fidelity_f64 - (1 - loss)|, iterations,
evaluations and wall seconds.  qoc_tpu's values set phase 9a's bars
(``QOC_TPU_1ML``).

``--floor`` also prints, per run, ``floor {...}``: the readout error
(1 - loss) - fidelity_f64 of the port's lean and analysis forwards on
each engine (scan, associative, tree) at the final pulse and at five
pulses within 1e-3 of it (seed 0): how far the float32 loss of a
per-iteration engine sits from float64 at T = 1000, whatever the driver.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = [("spin_pi", "LBFGS"), ("spin_pi", "L-BFGS-B"), ("spin_pi", "BFGS"),
        ("cnot", "LBFGS"), ("cnot", "L-BFGS-B")]


def _floor(problem, u_base, device):
    import torch

    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.utils import analysis

    rng = np.random.default_rng(0)
    pulses = [u_base] + [u_base + 1e-3 * rng.standard_normal(u_base.shape)
                         for _ in range(5)]
    out = {}
    for engine in ("scan", "associative", "tree"):
        for lean in (True, False):
            forward, loss_fn = make_forward(problem, engine=engine,
                                            lean=lean, device=device)
            errs = []
            for u in pulses:
                u = u.astype(np.float32)
                with torch.no_grad():
                    t = torch.as_tensor(u, device=device)
                    res = loss_fn(t)[1] if lean else forward(t)
                f64 = analysis.fidelity_f64(
                    problem, analysis.uks_from_base(problem, u))
                errs.append((1.0 - float(res.loss)) - f64)
            out[f"{engine}_{'lean' if lean else 'analysis'}"] = errs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("qoc_tpu", "port"),
                    required=True)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (default cpu)")
    ap.add_argument("--conv-target", type=float, default=1e-5)
    ap.add_argument("--floor", action="store_true",
                    help="the port's readout floor per engine")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    os.environ.setdefault("QOC_TPU_QUIET", "1")
    from qoc_tpu_torch.utils.jobs import load_job

    if args.package == "qoc_tpu":
        import qoc_tpu as q

        grape = q.Grape
    else:
        import qoc_tpu_torch as qt

        def grape(**kw):
            return qt.Grape(device=args.device, **kw)
    for name, method in RUNS:
        kw = load_job(os.path.join(HERE, "examples", "jobs", name + ".json"))
        kw.update(save=False, show_plots=False, method=method)
        kw["convergence"] = dict(kw["convergence"],
                                 conv_target=args.conv_target)
        t0 = time.perf_counter()
        res = grape(**kw)
        wall = time.perf_counter() - t0
        loss = float(res.loss)
        print("run " + json.dumps(dict(
            package=args.package, problem=name, method=method,
            conv_target=args.conv_target, one_minus_loss=1.0 - loss,
            fidelity_f64=float(res.fidelity_f64),
            gap=abs(float(res.fidelity_f64) - (1.0 - loss)),
            iterations=int(res.iterations), nfev=res.nfev, wall_s=wall)),
            flush=True)
        if args.floor and args.package == "port":
            print("floor " + json.dumps(dict(
                problem=name, method=method,
                **_floor(res.problem, res.u_base, args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
