"""Convergence hyperparameters and optimization history bookkeeping.

Parity: core/convergence.py:16-49 defaults (rate=0.01, update_step=100,
evol_save_step=100, conv_target=1e-8, max_iterations=5000,
learning_rate_decay=2500, min_grad=1e-25).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ConvergenceSettings:
    rate: float = 0.01
    update_step: int = 100
    evol_save_step: int = 100
    conv_target: float = 1e-8
    max_iterations: int = 5000
    learning_rate_decay: float = 2500.0
    min_grad: float = 1e-25

    @staticmethod
    def from_dict(convergence: Optional[dict]) -> "ConvergenceSettings":
        convergence = convergence or {}
        defaults = ConvergenceSettings()
        return ConvergenceSettings(
            rate=convergence.get("rate", defaults.rate),
            update_step=int(convergence.get("update_step", defaults.update_step)),
            evol_save_step=int(
                convergence.get("evol_save_step", defaults.evol_save_step)
            ),
            conv_target=convergence.get("conv_target", defaults.conv_target),
            max_iterations=int(
                convergence.get("max_iterations", defaults.max_iterations)
            ),
            learning_rate_decay=convergence.get(
                "learning_rate_decay", defaults.learning_rate_decay
            ),
            min_grad=convergence.get("min_grad", defaults.min_grad),
        )

    def learning_rate(self, iteration: int) -> float:
        """rate * exp(-iter / decay) (run_session.py:66)."""
        import numpy as np

        return float(self.rate) * float(
            np.exp(-float(iteration) / float(self.learning_rate_decay))
        )


@dataclasses.dataclass
class History:
    """Error-curve history appended every update_step (convergence.py:56-84)."""

    iterations: list = dataclasses.field(default_factory=list)
    costs: list = dataclasses.field(default_factory=list)
    reg_costs: list = dataclasses.field(default_factory=list)
    grad_squareds: list = dataclasses.field(default_factory=list)
    unitary_scales: list = dataclasses.field(default_factory=list)
    learning_rates: list = dataclasses.field(default_factory=list)

    def record(self, iteration, loss, reg_loss, grad_sq, unitary_scale,
               lr=None):
        self.iterations.append(int(iteration))
        self.costs.append(float(loss))
        self.reg_costs.append(float(reg_loss))
        self.grad_squareds.append(float(grad_sq))
        self.unitary_scales.append(float(unitary_scale))
        # per-update learning rate (core/convergence.py:59 bookkeeping);
        # None for optimizers without an LR schedule (BFGS/L-BFGS)
        self.learning_rates.append(None if lr is None else float(lr))
