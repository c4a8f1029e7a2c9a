"""BASELINE config 5 on qoc_tpu_torch: a seed x Hamiltonian sweep on the
CUDA card (the port of examples/05_pod_scale_sweep.py).

``--full`` runs config 5 at spec: **4096 seeds x a 64-point
cavity-detuning grid on the dim-200 multimode cavity** (qubit x 100-level
cavity, M = 400 in the real isomorphism, T = 200), optimized through the
column-batched ``xla-cols`` backend (``parallel/cols_batch.py``) in
2048-column chunks with per-seed convergence freezing, rate 0.06, up to
1200 iterations, conv_target 1e-4.  Without ``--full`` it runs the same
problem cut in depth: 512 seeds, 100 iterations, one chunk.

``--quick`` is qoc_tpu's default program (``run_quick``) with its mesh
(``parallel.mesh.make_mesh``: the ranks of a ``torchrun`` launch, or a
world of one): 512 pi-pulse seeds (T = 1000) through
``batched_grape_adam(mesh=...)``, then a 512-point detuning sweep through
``make_mega_batched_runner(mesh=...)``, 500 iterations on kernel 6.
qoc_tpu runs it without an option; here the default stays the config-5
cut.

It prints one JSON line: qoc_tpu's report fields (solves/s, seed
iterations/s, best and median loss, converged count) with the card's name
and power limit, the peak device memory and ms per chunk-iteration, and
writes it to a file only when given ``--out``.  The seeds' initial pulses
come from ``torch.Generator``, not ``jax.random``, so qoc_tpu's
CONFIG5_RESULTS.json (a TPU run) is history to set beside the result, not
a target to match.

Run:  python examples/torch_05_pod_scale_sweep.py [--full | --quick]
          [--seeds N] [--grid N] [--iters N] [--chunk N] [--rate R]
          [--device cpu] [--out FILE]
      torchrun --nproc-per-node 4 examples/torch_05_pod_scale_sweep.py \
          --quick
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import qoc_tpu_torch as q  # noqa: E402
from qoc_tpu_torch.interop import entry_device  # noqa: E402
from qoc_tpu_torch.models.system import ControlProblem  # noqa: E402
from qoc_tpu_torch.ops.isomorphism import c_to_r_mat  # noqa: E402
from qoc_tpu_torch.optim.convergence import ConvergenceSettings  # noqa: E402
from qoc_tpu_torch.parallel.batch import (  # noqa: E402
    batched_grape_adam, init_seeds)
from qoc_tpu_torch.parallel.mega_batch import (  # noqa: E402
    make_mega_batched_runner)
from qoc_tpu_torch.parallel.mesh import (  # noqa: E402
    gather, init_distributed, make_mesh)
from qoc_tpu_torch.utils import profiling  # noqa: E402


# (seeds, iterations, columns per chunk) with and without --full
FULL = (4096, 1200, 2048)
CUT = (512, 100, 512)
# --quick: qoc_tpu's run_quick (examples/05_pod_scale_sweep.py:150-188)
QUICK_SEEDS = 512
QUICK_CONV = {"rate": 0.01, "update_step": 100, "max_iterations": 2000,
              "conv_target": 1e-6}
QUICK_SWEEP_ITERATIONS = 500


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


def pi_pulse():
    """run_quick's qubit pi pulse: T = 1000, maxA 0.7."""
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, 1000,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0)


def quick_seeds(mesh, device=None):
    """run_quick's seeds-only batch: 512 pi-pulse seeds sharded over
    ``mesh`` (batched_grape_adam's result dict, global on every rank)."""
    return batched_grape_adam(pi_pulse(), n_seeds=QUICK_SEEDS,
                              convergence=QUICK_CONV, seed=0, mesh=mesh,
                              device=device)


def quick_sweep(mesh, device=None):
    """run_quick's detuning sweep optimized through the fused
    batched-optimizer kernel: seed s at detuning 0.2 * s / 511, 500
    iterations in one launch per rank.  Returns the global losses."""
    problem = pi_pulse()
    num = np.diag([0.0, 1.0]).astype(complex)
    extra = np.stack([c_to_r_mat(-1j * problem.dt * num)]).astype(np.float32)
    deltas = np.linspace(0.0, 0.2, QUICK_SEEDS)[:, None].astype(np.float32)
    u = init_seeds(problem, QUICK_SEEDS, torch.Generator().manual_seed(1))
    init_state, run_n, _ = make_mega_batched_runner(
        problem, ConvergenceSettings.from_dict(QUICK_CONV),
        extra_channel_mats=extra, mesh=mesh, device=device)
    state = run_n(init_state(u), QUICK_SWEEP_ITERATIONS,
                  extra_weights=deltas)
    return gather(state.losses, mesh).cpu().numpy()


def run_quick(mesh, device=None):
    """qoc_tpu's default program on ``mesh``; returns the report (rank 0
    prints qoc_tpu's two lines)."""
    out = quick_seeds(mesh, device)
    losses = quick_sweep(mesh, device)
    rep = {"program": "quick", "ranks": mesh.size(),
           "card": profiling.card(entry_device(device)), "seeds": QUICK_SEEDS,
           "best_loss": out["best_loss"],
           "converged": int(np.sum(out["converged"])),
           "iterations": out["iterations"],
           "sweep_best_loss": float(losses.min()),
           "sweep_worst_loss": float(losses.max()),
           # the results' bits, to hold runs on other numbers of ranks
           # against each other
           "sha256": hashlib.sha256(b"".join(
               np.ascontiguousarray(x).tobytes() for x in (
                   out["losses"], out["u_base"], losses))).hexdigest()}
    if mesh.get_local_rank() == 0:
        print(f"{QUICK_SEEDS} seeds: best loss {out['best_loss']:.2e}, "
              f"{rep['converged']} converged", flush=True)
        print(f"sweep after {QUICK_SWEEP_ITERATIONS} iters: best "
              f"{losses.min():.2e} worst {losses.max():.2e} (detuning "
              "0..0.2)", flush=True)
    return rep


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
        "card": profiling.card(device),
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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--full", action="store_true",
                      help="config 5 at spec (4096 seeds, 1200 iterations, "
                           "2048-column chunks); default 512 seeds, 100 "
                           "iterations, one chunk")
    mode.add_argument("--quick", action="store_true",
                      help="qoc_tpu's default program with its mesh: 512 "
                           "pi-pulse seeds, then a detuning sweep on "
                           "kernel 6")
    ap.add_argument("--seeds", type=int, default=None)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--rate", type=float, default=0.06)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if args.quick:
        if "WORLD_SIZE" in os.environ:    # started by torchrun
            init_distributed()
        mesh = make_mesh()
        rep = run_quick(mesh, device=args.device)
        rank = mesh.get_local_rank()
        torch.distributed.destroy_process_group()
        if rank != 0:
            return rep
    else:
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
