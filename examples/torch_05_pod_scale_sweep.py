"""BASELINE config 5 on qoc_tpu_torch: a seed x Hamiltonian sweep on one
CUDA card (the port of examples/05_pod_scale_sweep.py's ``--full``
program, without its mesh).

``--full`` runs config 5 at spec: **4096 seeds x a 64-point
cavity-detuning grid on the dim-200 multimode cavity** (qubit x 100-level
cavity, M = 400 in the real isomorphism, T = 200), optimized through the
column-batched ``xla-cols`` backend (``parallel/cols_batch.py``) in
2048-column chunks with per-seed convergence freezing, rate 0.06, up to
1200 iterations, conv_target 1e-4.  Without ``--full`` it runs the same
problem cut in depth: 512 seeds, 100 iterations, one chunk.

It prints one JSON line: qoc_tpu's report fields (solves/s, seed
iterations/s, best and median loss, converged count) with the card's name
and power limit, the peak device memory and ms per chunk-iteration, and
writes it to a file only when given ``--out``.  The seeds' initial pulses
come from ``torch.Generator``, not ``jax.random``, so qoc_tpu's
CONFIG5_RESULTS.json (a TPU run) is history to set beside the result, not
a target to match.

Run:  python examples/torch_05_pod_scale_sweep.py [--full] [--seeds N]
          [--grid N] [--iters N] [--chunk N] [--rate R] [--device cpu]
          [--out FILE]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from qoc_tpu_torch.interop import entry_device  # noqa: E402
from qoc_tpu_torch.models.system import ControlProblem  # noqa: E402
from qoc_tpu_torch.ops.isomorphism import c_to_r_mat  # noqa: E402
from qoc_tpu_torch.parallel.batch import batched_grape_adam  # noqa: E402
from qoc_tpu_torch.utils import profiling  # noqa: E402

# (seeds, iterations, columns per chunk) with and without --full
FULL = (4096, 1200, 2048)
CUT = (512, 100, 512)


def build_dim200():
    """Qubit x 100-level cavity (Hilbert dim 200), qubit rotating frame."""
    Nc = 100
    a = np.kron(np.eye(2), np.diag(np.sqrt(np.arange(1, Nc)), 1))
    sm = np.kron(np.array([[0, 1], [0, 0]]), np.eye(Nc))
    H0 = (2 * np.pi * 0.1 * (a.conj().T @ a)
          + 2 * np.pi * 0.05 * (a.conj().T @ sm + a @ sm.conj().T))
    Hops = [sm + sm.conj().T, 1j * (sm - sm.conj().T), a + a.conj().T]
    psi0 = np.zeros(2 * Nc, complex)
    psi0[0] = 1
    tgt = np.zeros(2 * Nc, complex)
    tgt[Nc] = 1
    problem = ControlProblem.build(
        H0, Hops, ["x", "y", "c"], [tgt], 4.0, 200, [psi0],
        state_transfer=True, maxA=[2 * np.pi * 0.3] * 3, seed=0,
    )
    n_op = np.asarray(a.conj().T @ a)
    return problem, n_op


def detuning_channel(problem, n_op, n_seeds: int, n_grid: int):
    """(extra [1, M, M], deltas [n_seeds, 1], grid): the detuning as one
    constant-weight extra channel -1j*dt*n_cavity, seed s at
    grid[s % n_grid]."""
    extra = np.stack(
        [c_to_r_mat(-1j * problem.dt * n_op)]).astype(np.float32)
    grid = np.linspace(-0.1, 0.1, n_grid).astype(np.float32)
    deltas = grid[np.arange(n_seeds) % n_grid][:, None]
    return extra, deltas, grid


def card(device) -> str:
    """``name, power limit`` of the card as nvidia-smi gives them, or the
    device's type off the card."""
    if device.type != "cuda":
        return device.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run_full(n_seeds=4096, n_grid=64, max_iterations=1200,
             conv_target=1e-4, chunk=2048, rate=0.06, device=None):
    """Config 5: ``n_seeds`` random pulse inits x ``n_grid`` cavity
    detunings (repeated over the seed axis) on dim 200 through xla-cols,
    in chunks of ``chunk`` columns; chunk c0 draws its inits from
    ``seed=c0 // chunk``.  Returns the report."""
    device = entry_device(device)
    problem, n_op = build_dim200()
    extra, deltas, grid = detuning_channel(problem, n_op, n_seeds, n_grid)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    losses_all, conv_all, chunk_ms = [], [], []
    iters_total = 0
    for c0 in range(0, n_seeds, chunk):
        c1 = min(c0 + chunk, n_seeds)

        def progress(it, losses, done, c0=c0, c1=c1):
            print(f"  seeds [{c0}:{c1}] iter {it}: best "
                  f"{np.min(losses):.2e} converged "
                  f"{int(np.sum(done))}/{c1 - c0}", flush=True)

        tc = time.perf_counter()
        out = batched_grape_adam(
            problem, n_seeds=c1 - c0,
            convergence={"rate": rate, "update_step": 50,
                         "max_iterations": max_iterations,
                         "conv_target": conv_target},
            seed=c0 // chunk, backend="xla-cols",
            extra_channels=(extra, deltas[c0:c1]),
            progress=progress, device=device,
        )
        chunk_ms.append(1e3 * (time.perf_counter() - tc) / out["iterations"])
        losses_all.append(out["losses"])
        conv_all.append(out["converged"])
        iters_total += (c1 - c0) * out["iterations"]
    wall = time.perf_counter() - t0
    losses = np.concatenate(losses_all)
    converged = np.concatenate(conv_all)
    conv_count = int(np.sum(converged & (losses < conv_target)))
    mem = profiling.memory_stats(device)
    rep = {
        "config": "BASELINE config 5 (dim 200, seeds x detuning grid)",
        "card": card(device),
        "n_seeds": n_seeds,
        "n_grid": n_grid,
        "dim": problem.state_num,
        "steps": problem.steps,
        "iterations": iters_total // n_seeds,
        "chunk_cols_per_launch": chunk,
        "wall_s": wall,
        "seed_iters_per_sec": iters_total / wall,
        "ms_per_chunk_iteration": chunk_ms,
        "peak_device_bytes": (None if mem is None
                              else mem["max_memory_allocated"]),
        "best_loss": float(np.min(losses)),
        "best_fidelity": 1.0 - float(np.min(losses)),
        "converged_count": conv_count,
        "converged_frac": conv_count / n_seeds,
        "seeds_below_gate": int(np.sum(losses < conv_target)),
        # completed optimizations (loss < gate) per second of wall clock
        "solves_per_sec": conv_count / wall,
        "median_loss": float(np.median(losses)),
        "best_loss_first_8_grid_points": {
            float(g): float(np.min(losses[np.arange(n_seeds) % n_grid == i]))
            for i, g in enumerate(grid[:min(8, n_seeds)])
        },
    }
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="config 5 at spec (4096 seeds, 1200 iterations, "
                         "2048-column chunks); default 512 seeds, 100 "
                         "iterations, one chunk")
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--rate", type=float, default=0.06)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    seeds, iters, chunk = FULL if args.full else CUT
    rep = run_full(n_seeds=args.seeds or seeds, n_grid=args.grid,
                   max_iterations=args.iters or iters,
                   chunk=args.chunk or chunk, rate=args.rate,
                   device=args.device)
    print(json.dumps(rep), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
