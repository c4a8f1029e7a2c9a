"""Full-scale reference-example parity pack of qoc_tpu_torch (the
counterpart of examples/parity_pack.py, BASELINE.md's correctness row).

Runs the BASELINE jobs at published scale (steps = 1000, the reference's
convergence budgets) through the port's job path (``utils.jobs.load_job``,
``Grape(**cfg)``) on the card, and measures per job:

  * final fidelity 1 - loss and iterations to convergence;
  * the oracle fidelity: the coherent fidelity |sum_v <t_v|psi_v>|^2 / V^2
    recomputed in float64 from the run's pulses by an independent
    propagator (scipy's expm), and its delta from the run's own float64
    readout (``GrapeResult.fidelity_f64``) and from its float32 loss;
  * the intermediate states of the run (``GrapeResult.inter_vecs``)
    against the expm and the adaptive-ODE oracles
    (``utils.verification.verify_states``, ``verify_run``'s comparison on
    arrays): max-abs-diff and all_close at atol 1e-4;
  * uks agreement of the fused segment kernel (or, where it does not
    admit the job, the engine ``Grape`` routes it to) and the scan engine
    over a 200-iteration prefix at full scale (the whole-run comparison
    is not well posed: float32 rounding differences grow through
    thousands of nonconvex iterations).

The card's machine has no h5py, so ``Grape`` runs with ``save=False`` and
every check reads the result's arrays.  ``--out DIR`` writes
``DIR/PARITY_RESULTS.json``; the markdown table is always printed.

Usage:  python examples/torch_parity_pack.py [--out DIR] [--jobs a,b]
            [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from qoc_tpu_torch import Grape  # noqa: E402
from qoc_tpu_torch.utils.analysis import inter_vecs_to_complex  # noqa: E402
from qoc_tpu_torch.utils.jobs import load_job  # noqa: E402
from qoc_tpu_torch.utils.verification import (  # noqa: E402
    scipy_oracle_states, verify_states)

CONFIG_NAMES = ["spin_pi", "cnot", "transmon_leakage", "transmon_cavity"]
JOBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jobs")
PREFIX_ITERATIONS = 200


def oracle_fidelity(cfg: dict, res) -> float:
    """Coherent gate fidelity |sum_v <t_v|psi_v^oracle>|^2 / V^2 in
    float64 from the run's pulses by the independent expm propagator
    (inner_product_2D semantics, tensorflow_state.py:282-300)."""
    p = res.problem
    H0 = np.asarray(cfg["H0"])
    Hops = np.asarray(cfg["Hops"])
    init_vecs = p.initial_vectors_c                   # [V, N]
    U = np.asarray(cfg["U"])
    if U.ndim == 1:
        U = U[None, :]
    V = len(init_vecs)
    ov = 0.0 + 0.0j
    for v in range(V):
        final = scipy_oracle_states(H0, Hops, res.uks, cfg["total_time"],
                                    cfg["steps"], init_vecs[v])[:, -1]
        target = U[v] if p.state_transfer else U @ init_vecs[v]
        ov += np.vdot(target, final)
    return float(np.abs(ov) ** 2 / (V * V))


def verify_result(cfg: dict, res, atol: float = 1e-4,
                  oracle: str = "scipy") -> dict:
    """``verify_run``'s report ({max_abs_diff, all_close}, one entry per
    initial vector) for a run that was not saved: its intermediate states
    against the oracle's re-simulation of its pulses."""
    p = res.problem
    return verify_states(np.asarray(cfg["H0"]), np.asarray(cfg["Hops"]),
                         res.uks, cfg["total_time"], cfg["steps"],
                         p.initial_vectors_c,
                         inter_vecs_to_complex(p, res.inter_vecs),
                         atol=atol, oracle=oracle)


def uks_prefix_agreement(cfg: dict, device, n_iters: int = PREFIX_ITERATIONS
                         ) -> tuple:
    """(max|uks_a - uks_scan|, engine a) after ``n_iters`` full-scale
    iterations of ``Grape(engine="mega")`` and of the scan engine (both
    exact-gradient Adam, from the same seeded pulse).  Engine a is the
    fused segment kernel where it admits the job, else the engine
    ``Grape`` routed the job to instead, as it reports."""
    base = dict(cfg)
    base.pop("data_path", None)
    base.update(save=False, show_plots=False, device=device)
    base["convergence"] = dict(
        cfg.get("convergence") or {},
        max_iterations=n_iters, conv_target=-1.0, update_step=n_iters)
    r_mega = Grape(**base, engine="mega")
    r_scan = Grape(**base, engine="scan")
    return (float(np.max(np.abs(np.asarray(r_mega.uks)
                                - np.asarray(r_scan.uks)))), r_mega.engine)


def run_pack(names=CONFIG_NAMES, device=None, outdir=None,
             jobs_dir=JOBS_DIR):
    results = []
    for name in names:
        cfg = load_job(os.path.join(jobs_dir, f"{name}.json"))
        cfg.update(save=False, show_plots=False)
        print(f"=== {name}: optimizing at published scale ===", flush=True)
        t0 = time.time()
        res = Grape(**cfg, device=device)
        wall = time.time() - t0
        print(f"  loss={res.loss:.3e} iters={res.iterations} "
              f"wall={wall:.1f}s engine={res.engine}", flush=True)

        ver = verify_result(cfg, res)
        ver_ode = verify_result(cfg, res, oracle="ode")
        f_oracle = oracle_fidelity(cfg, res)
        # the run's float64 readout against the float64 oracle compares
        # the algorithms (Taylor vs Pade); the float32 loss keeps its own
        # accumulation floor, reported beside it
        delta = abs(res.fidelity_f64 - f_oracle)
        delta_f32 = abs((1.0 - res.loss) - f_oracle)
        print(f"  oracle F={f_oracle:.9f} delta={delta:.2e} "
              f"delta_f32_reported={delta_f32:.2e} "
              f"expm max_abs_diff={max(ver['max_abs_diff']):.2e} "
              f"ode max_abs_diff={max(ver_ode['max_abs_diff']):.2e}",
              flush=True)
        du, prefix_engine = uks_prefix_agreement(cfg, device)
        print(f"  uks {PREFIX_ITERATIONS}-iter {prefix_engine}-vs-scan "
              f"max|du|={du:.2e}", flush=True)
        results.append({
            "config": name,
            "steps": cfg["steps"],
            "total_time": cfg["total_time"],
            "engine": res.engine,
            "final_loss": res.loss,
            "final_fidelity": 1.0 - res.loss,
            "fidelity_f64": res.fidelity_f64,
            "iterations": res.iterations,
            "wall_s": wall,
            "oracle_fidelity": f_oracle,
            "oracle_fidelity_delta_f64": delta,
            "oracle_fidelity_delta": delta_f32,
            "verify_expm_max_abs_diff": max(ver["max_abs_diff"]),
            "verify_expm_all_close": all(ver["all_close"]),
            "verify_ode_max_abs_diff": max(ver_ode["max_abs_diff"]),
            "verify_ode_all_close": all(ver_ode["all_close"]),
            f"uks_prefix_{PREFIX_ITERATIONS}_max_dev": du,
            "uks_prefix_engines": f"{prefix_engine} vs scan",
        })

    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "PARITY_RESULTS.json"), "w") as f:
            json.dump(results, f, indent=1)

    print("\n| config | steps | fidelity | iters | oracle-F delta (f64) | "
          "expm maxdiff | ode maxdiff | uks prefix dev |")
    print("|---|---|---|---|---|---|---|---|")
    for r in results:
        print(f"| {r['config']} | {r['steps']} | "
              f"{r['final_fidelity']:.8f} | {r['iterations']} | "
              f"{r['oracle_fidelity_delta_f64']:.2e} | "
              f"{r['verify_expm_max_abs_diff']:.2e} | "
              f"{r['verify_ode_max_abs_diff']:.2e} | "
              f"{r[f'uks_prefix_{PREFIX_ITERATIONS}_max_dev']:.2e} |")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for PARITY_RESULTS.json")
    ap.add_argument("--jobs", default=",".join(CONFIG_NAMES),
                    help="comma-separated job names of examples/jobs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu runs the plain torch versions (default: the "
                         "card)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("torch_parity_pack: torch sees no CUDA device; pass "
              "--device cpu", file=sys.stderr)
        return 2
    run_pack(args.jobs.split(","), args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
