"""A closed loop of whole ``Grape`` Adam solves: each solve starts when the
one before it has returned, with routing left to the entry
(``engine="auto"``), nothing saved and no plots.  The window runs solves
until ``seconds`` have passed at the end of one; every solve started is
finished and counted.

Each solve starts from an initial guess of its own, drawn from
``--seed`` and the solve's index; the set-up's check call starts from
one more.

Traffic keys: ``generator`` ("grape_loop"), ``check_answers`` (how many
of the window's solves the reference checks, drawn from the seed),
``trace_seconds`` (the traced window's length), and optionally
``convergence`` (overrides of the configuration's Adam settings).  The
system's ``grape_kwargs``, where it has them (a dressed basis, say), go
to ``Grape`` untouched.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark.check import CHECK_STEPS
from benchmark.harness import RouteSink, derive_seed


class Generator:
    def __init__(self, cell, device, seed: int):
        import qoc_tpu_torch as q

        self.q = q
        self.cell = cell
        self.device = device
        self.seed = int(seed)
        self.sink = RouteSink()
        s = cell.system
        self.args = (s["H0"], s["Hops"], s["Hnames"], s["target"],
                     s["total_time"], s["steps"], s["states"])
        self.maxA = np.asarray(s["maxA"], dtype=np.float64)
        self.K, self.T = len(s["Hops"]), int(s["steps"])
        self.seeds_per_call = 1
        self.check = None
        self.solves = []          # (wall s, iterations)
        self.answers = []         # (u_base [K, T], loss, reg_loss)
        self.calls = 0

    def initial_guess(self, seed: int) -> np.ndarray:
        """The physical pulses [K, T] drawn from ``seed``: maxA sin(u) of a
        base-domain draw u ~ N(0, 1/steps)."""
        g = torch.Generator().manual_seed(seed)
        u = torch.randn((self.K, self.T), generator=g, dtype=torch.float32)
        u = (u / np.sqrt(self.T)).double().numpy()
        return self.maxA[:, None] * np.sin(u)

    def solve(self, guess, conv):
        s = self.cell.system
        with contextlib.redirect_stdout(self.sink):
            with torch.profiler.record_function("bench.solve"):
                return self.q.Grape(
                    *self.args, convergence=conv,
                    reg_coeffs=s["reg_coeffs"] or None, maxA=s["maxA"],
                    initial_guess=guess, method="Adam",
                    state_transfer=s["state_transfer"], save=False,
                    show_plots=False, device=self.device,
                    **(s.get("grape_kwargs") or {}))

    def prepare(self) -> None:
        """The warm-up: one solve at the cell's shapes through the same
        segments as the window's, cut to ``CHECK_STEPS`` iterations with
        the cell's check settings; its readings are the check's."""
        guess = self.initial_guess(derive_seed(self.seed, 1))
        conv = self.cell.check_conv(CHECK_STEPS)
        res = self.solve(guess, conv)
        self.check = {
            "conv": conv,
            "u0": np.arcsin(guess / self.maxA[:, None])[None],
            "extra_w": None,
            "loss": np.array([res.loss], dtype=np.float64),
            "reg_loss": np.array([res.reg_loss], dtype=np.float64),
            "grad_norm": np.sqrt(2.0 * np.asarray(
                res.history.grad_squareds[-1:], dtype=np.float64)),
            "u": np.asarray(res.u_base, dtype=np.float64)[None],
        }

    def window(self, seconds: float) -> dict:
        conv = self.cell.conv()
        t0 = time.perf_counter()
        while True:
            guess = self.initial_guess(derive_seed(self.seed, 7, self.calls))
            self.calls += 1
            ts = time.perf_counter()
            res = self.solve(guess, conv)
            self.solves.append((time.perf_counter() - ts,
                                int(res.iterations)))
            self.answers.append((np.asarray(res.u_base, dtype=np.float32),
                                 float(res.loss), float(res.reg_loss)))
            if time.perf_counter() - t0 >= seconds:
                break
        return {"window_s": time.perf_counter() - t0,
                "solve_walls": [w for w, _ in self.solves],
                "solve_iterations": [i for _, i in self.solves],
                "seed_iterations": sum(i for _, i in self.solves),
                "iterations": sum(i for _, i in self.solves),
                "attempted": self.calls}

    def sampled_answers(self):
        n = min(int(self.cell.traffic["check_answers"]), len(self.answers))
        if n == 0:
            return None
        rng = np.random.default_rng(derive_seed(self.seed, 2))
        pick = np.sort(rng.choice(len(self.answers), n, replace=False))
        return {"u": np.stack([self.answers[i][0] for i in pick]),
                "extra_w": None,
                "losses": np.array([self.answers[i][1] for i in pick]),
                "reg_losses": np.array([self.answers[i][2] for i in pick])}
