"""Per-iteration Adam runner (port of ``qoc_tpu.optim.adam``).

One iteration = one autograd value-and-grad of the lean loss plus one Adam
step, with the reference's semantics (run_session.py:47-69): metrics are
evaluated at the CURRENT iterate, the convergence test (loss <
conv_target, grad^2 < min_grad, iteration >= max_iterations) runs on
them, and on convergence the update is skipped and the iterate frozen.

Adam is TF1's (beta1 0.9, beta2 0.999, eps 1e-8, bias-corrected moments);
the learning rate ``rate * exp(-iter / decay)`` is carried as state and
multiplied by exp(-1/decay) after every applied step.  The fused segment
kernel (``ops.mega``) shares this state type.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .convergence import ConvergenceSettings

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamState(NamedTuple):
    u_base: torch.Tensor       # [K, T] (the segment kernel: [K, Tp], zero-padded)
    m: torch.Tensor            # first moment, same shape
    v: torch.Tensor            # second moment, same shape
    lr: float                  # current learning rate (a float32 value)
    iteration: int
    loss: float
    reg_loss: float
    grad_squared: float
    unitary_scale: float
    done: bool


def init_adam_state(u_base: torch.Tensor, conv: ConvergenceSettings
                    ) -> AdamState:
    u = u_base.detach().clone()
    return AdamState(
        u_base=u, m=torch.zeros_like(u), v=torch.zeros_like(u),
        lr=float(np.float32(conv.rate)), iteration=0,
        loss=float("inf"), reg_loss=float("inf"),
        grad_squared=float("inf"), unitary_scale=0.0, done=False,
    )


def make_segment_runner(loss_fn: Callable, conv: ConvergenceSettings):
    """``run_segment(state, stop_at)``: iterate until converged or
    ``state.iteration == stop_at``.  ``loss_fn(u_base) -> (reg_loss,
    ForwardOutput)``."""
    factor = np.float32(np.exp(-1.0 / float(conv.learning_rate_decay)))

    def run_segment(state: AdamState, stop_at: int) -> AdamState:
        s = state
        while not s.done and s.iteration < stop_at:
            u = s.u_base.detach().requires_grad_(True)
            reg_loss, out = loss_fn(u)
            (g,) = torch.autograd.grad(reg_loss, u)
            g2 = float(0.5 * torch.sum(g * g))
            loss = float(out.loss.detach())
            converged = (loss < conv.conv_target or g2 < conv.min_grad
                         or s.iteration >= conv.max_iterations)
            metrics = dict(loss=loss, reg_loss=float(reg_loss.detach()),
                           grad_squared=g2,
                           unitary_scale=float(out.unitary_scale.detach()))
            if converged:
                s = s._replace(done=True, **metrics)
                break
            count = s.iteration + 1
            m = B1 * s.m + (1.0 - B1) * g
            v = B2 * s.v + (1.0 - B2) * (g * g)
            m_hat = m / (1.0 - B1 ** count)
            v_hat = v / (1.0 - B2 ** count)
            u_new = s.u_base - s.lr * (m_hat / (torch.sqrt(v_hat) + EPS))
            s = s._replace(
                u_base=u_new.detach(), m=m, v=v,
                lr=float(np.float32(s.lr) * factor), iteration=count,
                **metrics)
        return s

    return run_segment
