"""A closed loop of seed batches through ``batched_grape_adam``: random
restarts, or a Hamiltonian sweep where the configuration has extra
operators (seed s of a batch at the grid's point s % len(grid)).  Each
batch runs to ``max_iterations`` or until every seed has converged, then
the next starts from fresh seeds drawn from ``--seed``; routing is left
to the entry (``backend="auto"``).  The window closes at the first
``update_step`` boundary after ``seconds``, seen through the entry's
``progress`` hook.

On more than one card (``ranks``) every rank makes the same calls with
the mesh of the seed axis, each on its contiguous shard of every batch;
the entry's ``progress`` hook sees the global losses and flags on every
rank, so the seed-iterations count every shard's live seeds.  Rank 0's
clock decides when the window closes, and the decision is broadcast at
each boundary, so that every rank leaves the same call at the same
boundary.  The check's seeds and the answers are drawn in equal numbers
from each rank's shard, so that a fault on any one card shows.

Traffic keys: ``generator`` ("batch_loop"), ``seeds`` (per batch),
``check_seeds`` (how many of the check's seeds the reference follows,
drawn from the seed), ``check_answers`` (how many seeds of the window's
completed batches it checks), ``trace_seconds``, and optionally
``convergence``.  The system's ``grape_kwargs``, where it has them (a
dressed basis, say), go to ``ControlProblem.build`` untouched.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.check import CHECK_STEPS
from benchmark.harness import RouteSink, derive_seed
from benchmark.reference.grape import draw_seed_pulses


class WindowClosed(Exception):
    pass


def _iso(m: np.ndarray) -> np.ndarray:
    """The real form [[Re, -Im], [Im, Re]] of a complex matrix."""
    return np.block([[m.real, -m.imag], [m.imag, m.real]])


def _pick(rng, n: int, total: int, shards: int) -> np.ndarray:
    """``n`` of ``total`` rows drawn from ``rng``, in equal numbers from
    each of ``shards`` contiguous shards (one shard: a plain draw)."""
    if shards == 1:
        return np.sort(rng.choice(total, n, replace=False))
    k, per = total // shards, n // shards
    return np.concatenate([r * k + np.sort(rng.choice(k, per, replace=False))
                           for r in range(shards)])


class Generator:
    def __init__(self, cell, device, seed: int, ranks=None):
        from qoc_tpu_torch.models.system import ControlProblem
        from qoc_tpu_torch.parallel.batch import batched_grape_adam

        self.build = ControlProblem.build
        self.batched = batched_grape_adam
        self.cell = cell
        self.device = device
        self.seed = int(seed)
        self.ranks = ranks
        self.world = 1 if ranks is None else ranks.world
        self.lead = ranks is None or ranks.lead
        self.mesh = None if ranks is None else ranks.mesh
        self.sink = RouteSink()
        s = cell.system
        self.build_kwargs = s.get("grape_kwargs") or {}
        self.S = int(cell.traffic["seeds"])
        # the seeds this rank's card steps
        self.seeds_per_call = self.S // self.world
        self.K, self.T = len(s["Hops"]), int(s["steps"])
        self.extra = None
        self.extra_w = None
        if s.get("extra_ops") is not None:
            dt = s["total_time"] / s["steps"]
            self.extra = np.stack([_iso(-1j * dt * np.asarray(op))
                                   for op in s["extra_ops"]]
                                  ).astype(np.float32)
            grid = np.asarray(s["extra_grid"], dtype=np.float32)
            self.extra_w = grid[np.arange(self.S) % len(grid)][:, None]
        self.check = None
        self.answers = []      # (u [S,K,T], losses [S], reg [S])
        self.calls = 0
        self.seed_iterations = 0
        self.shard_seed_iterations = 0    # this rank's shard's part
        self.iterations = 0

    def batch_seed(self, index: int) -> int:
        return derive_seed(self.seed, 3, index)

    def run(self, seed: int, conv: dict, progress):
        s = self.cell.system
        with contextlib.redirect_stdout(self.sink):
            with torch.profiler.record_function("bench.batch"):
                problem = self.build(
                    s["H0"], s["Hops"], s["Hnames"], s["target"],
                    s["total_time"], s["steps"], s["states"],
                    maxA=s["maxA"], state_transfer=s["state_transfer"],
                    seed=0, **self.build_kwargs)
                return self.batched(
                    problem, n_seeds=self.S, convergence=conv,
                    reg_coeffs=s["reg_coeffs"] or None, seed=seed,
                    mesh=self.mesh,
                    extra_channels=(None if self.extra is None
                                    else (self.extra, self.extra_w)),
                    progress=progress, device=self.device)

    def prepare(self) -> None:
        """The warm-up: one batch at the cell's shapes through the same
        segments as the window's, cut to ``CHECK_STEPS`` iterations with
        the cell's check settings; the losses and pulses it returns are
        the check's readings for a sample of its seeds."""
        seed = self.batch_seed(0)
        conv = self.cell.check_conv(CHECK_STEPS)
        out = self.run(seed, conv, None)
        if not self.lead:
            return
        n = min(int(self.cell.traffic["check_seeds"]), self.S)
        rng = np.random.default_rng(derive_seed(self.seed, 4))
        pick = _pick(rng, n, self.S, self.world)
        u0 = draw_seed_pulses(self.S, self.K, self.T, seed).double().numpy()
        self.check = {
            "conv": conv,
            "u0": u0[pick],
            "extra_w": None if self.extra_w is None else self.extra_w[pick],
            "loss": np.asarray(out["losses"], np.float64)[pick],
            "reg_loss": np.asarray(out["reg_losses"], np.float64)[pick],
            "grad_norm": None,
            "u": np.asarray(out["u_base"], dtype=np.float64)[pick],
        }

    def window(self, seconds: float) -> dict:
        conv = self.cell.conv()
        t0 = time.perf_counter()
        closed = False
        agree = bool if self.ranks is None else self.ranks.agree
        k = self.S // self.world
        r = 0 if self.ranks is None else self.ranks.rank
        mine = slice(r * k, (r + 1) * k)
        while not closed:
            self.calls += 1
            seed = self.batch_seed(self.calls)
            state = {"it": 0, "live": self.S, "mine": k}

            def progress(it, losses, done, state=state):
                # ``done`` holds every shard's flags
                step = it - state["it"]
                self.seed_iterations += state["live"] * step
                self.shard_seed_iterations += state["mine"] * step
                self.iterations += step
                state["it"] = it
                live = ~np.asarray(done, dtype=bool)
                state["live"] = int(np.sum(live))
                state["mine"] = int(np.sum(live[mine]))
                if agree(time.perf_counter() - t0 >= seconds):
                    raise WindowClosed

            try:
                out = self.run(seed, conv, progress)
            except WindowClosed:
                closed = True
            else:
                if self.lead:
                    self.answers.append((np.asarray(out["u_base"]),
                                         np.asarray(out["losses"]),
                                         np.asarray(out["reg_losses"])))
                closed = agree(time.perf_counter() - t0 >= seconds)
        return {"window_s": time.perf_counter() - t0, "solve_walls": [],
                "solve_iterations": [],
                "seed_iterations": self.seed_iterations,
                "shard_seed_iterations": self.shard_seed_iterations,
                "iterations": self.iterations,
                "attempted": self.calls}

    def sampled_answers(self):
        if not self.answers:
            return None
        total = len(self.answers) * self.S
        n = min(int(self.cell.traffic["check_answers"]), total)
        rng = np.random.default_rng(derive_seed(self.seed, 5))
        if self.world == 1:
            pick = np.sort(rng.choice(total, n, replace=False))
            rows = [(self.answers[i // self.S], i % self.S) for i in pick]
        else:
            # rows of the batches' seeds, from each shard alike
            calls = rng.integers(len(self.answers), size=n)
            rows = [(self.answers[c], j) for c, j in
                    zip(calls, _pick(rng, n, self.S, self.world))]
        return {
            "u": np.stack([a[0][j] for a, j in rows]),
            "extra_w": (None if self.extra_w is None
                        else np.stack([self.extra_w[j] for _, j in rows])),
            "losses": np.array([a[1][j] for a, j in rows]),
            "reg_losses": np.array([a[2][j] for a, j in rows])}
