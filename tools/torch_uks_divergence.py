"""uks cross-engine divergence of qoc_tpu_torch (the counterpart of
tools/uks_divergence.py, PARITY.md's evidence).

The fused segment kernel (kernel 3) and the serial scan engine compute
the same math in different float32 orders, and a nonconvex Adam
trajectory amplifies any rounding difference.  This tool tells rounding-
seeded divergence from a real engine discrepancy, as qoc_tpu's does:

  * max|uks_A - uks_scan| every ``stride`` iterations up to ``n_iters``
    (engine A: kernel 3 where ``mega_supported`` admits the job, else the
    engine the card's ladder picks at the job's size: pscan at M >= 16,
    associative below);
  * the control: the scan engine run twice, from initial pulses one
    float32 ulp apart in every entry;
  * the iteration-0 gradient of both engines at the same pulse.

Both engines start from the same ``u0`` (the job's seeded guess).
Prints the JSON report and PARITY.md's markdown rows; ``--out`` also
writes the JSON.  Job files are read with ``utils.jobs.load_job``.

Usage:  python tools/torch_uks_divergence.py [--config JOB.json]
            [--iters N] [--stride N] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from qoc_tpu_torch.interop import entry_device  # noqa: E402


def _problem(cfg):
    from qoc_tpu_torch.models.system import ControlProblem

    return ControlProblem.build(
        cfg["H0"], cfg["Hops"], cfg["Hnames"], cfg["U"], cfg["total_time"],
        cfg["steps"], cfg["states_concerned_list"],
        maxA=cfg.get("maxA"), seed=cfg.get("seed", 0),
        state_transfer=cfg.get("state_transfer", False),
        dressed_info=cfg.get("dressed_info"),
    )


def _grad_at(loss_fn, u0: torch.Tensor) -> np.ndarray:
    u = u0.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(u)[0], u)
    return g.cpu().numpy()


def divergence_curves(cfg_path: str, n_iters: int = 200, stride: int = 10,
                      device=None):
    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.ops.mega import make_mega_segment_runner, mega_supported
    from qoc_tpu_torch.optim.adam import init_adam_state, make_segment_runner
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.utils.jobs import load_job

    dev = entry_device(device)
    cfg = load_job(cfg_path)
    rc = cfg.get("reg_coeffs") or None
    problem = _problem(cfg)
    conv = ConvergenceSettings.from_dict(
        dict(cfg.get("convergence") or {}, conv_target=-1.0,
             min_grad=-1.0, max_iterations=10 ** 6))
    maxamp = np.asarray(problem.ops_max_amp)[:, None]
    u0 = torch.as_tensor(np.asarray(problem.u0_base, np.float32),
                         device=dev)

    def segments(run, state):
        """uks after every ``stride`` iterations of a per-iteration
        runner."""
        out = {}
        for it in range(0, n_iters, stride):
            state = run(state, it + stride)
            out[it + stride] = maxamp * np.sin(state.u_base.cpu().numpy())
        return out

    # engine A: kernel 3 where it covers the job, else Grape's ladder on
    # the card (pscan at M >= 16, associative below)
    uks_a = {}
    if mega_supported(problem, rc):
        engine_a = "mega"
        init_m, run_m, unpad = make_mega_segment_runner(
            problem, conv, reg_coeffs=rc, device=dev)
        sm = init_m(problem.u0_base)
        for it in range(0, n_iters, stride):
            sm = run_m(sm, stride)
            uks_a[it + stride] = maxamp * np.sin(unpad(sm.u_base))
        sm0 = run_m(init_m(problem.u0_base), 1)
        g_a = sm0.m.cpu().numpy()[:, :problem.steps] / 0.1  # m1 = (1-b1) g
    else:
        engine_a = ("pscan" if 2 * problem.state_num >= 16
                    else "associative")
        _, loss_a = make_forward(problem, rc, engine=engine_a, lean=True,
                                 device=dev)
        uks_a = segments(make_segment_runner(loss_a, conv),
                         init_adam_state(u0, conv))
        g_a = _grad_at(loss_a, u0)

    # engine B: the serial scan, the same segments, and the ulp control
    _, loss_fn = make_forward(problem, rc, engine="scan", lean=True,
                              device=dev)
    run_seg = make_segment_runner(loss_fn, conv)
    uks_scan = segments(run_seg, init_adam_state(u0, conv))
    # control: EVERY entry one float32 ulp up (a single 1-ulp entry is
    # below sin's float32 resolution: the trajectories stay bit-identical)
    u0p = np.nextafter(np.asarray(problem.u0_base, dtype=np.float32),
                       np.float32(np.inf))
    uks_ulp = segments(run_seg, init_adam_state(
        torch.as_tensor(u0p, device=dev), conv))

    g_scan = _grad_at(loss_fn, u0)
    rows = [{"iteration": it,
             "cross_engine": float(np.max(np.abs(uks_a[it] - uks_scan[it]))),
             "ulp_control": float(np.max(np.abs(uks_ulp[it]
                                                - uks_scan[it])))}
            for it in sorted(uks_scan)]

    def rate(key):
        """log10 growth per iteration over the positive entries."""
        pts = [(r["iteration"], r[key]) for r in rows if r[key] > 0]
        if len(pts) < 2:
            return None
        its = np.array([p[0] for p in pts], float)
        lg = np.log10([p[1] for p in pts])
        return float(np.polyfit(its, lg, 1)[0])

    return {
        "config": os.path.basename(cfg_path),
        "engines": f"{engine_a} vs scan",
        "device": str(dev),
        "n_iters": n_iters,
        "grad_iter0_max_abs_dev": float(np.max(np.abs(g_a - g_scan))),
        "grad_iter0_scale": float(np.max(np.abs(g_scan))),
        "rows": rows,
        "growth_log10_per_iter": {
            "cross_engine": rate("cross_engine"),
            "ulp_control": rate("ulp_control"),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "examples", "jobs", "cnot.json"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu runs the plain torch versions (default: the "
                         "card)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("torch_uks_divergence: torch sees no CUDA device; pass "
              "--device cpu", file=sys.stderr)
        return 2
    rep = divergence_curves(args.config, n_iters=args.iters,
                            stride=args.stride, device=args.device)
    txt = json.dumps(rep, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    a = rep["engines"].split()[0]
    print(f"\n| iter | {a}-vs-scan | ulp control (scan-vs-scan) |")
    print("|---|---|---|")
    for r in rep["rows"]:
        print(f"| {r['iteration']} | {r['cross_engine']:.2e} | "
              f"{r['ulp_control']:.2e} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
