"""Per-iteration Adam runner (port of ``qoc_tpu.optim.adam``).

One iteration = one autograd value-and-grad of the lean loss plus one Adam
step, with the reference's semantics (run_session.py:47-69): metrics are
evaluated at the CURRENT iterate, the convergence test (loss <
conv_target, grad^2 < min_grad, iteration >= max_iterations) runs on
them, and on convergence the update is skipped and the iterate frozen.

Adam is TF1's (beta1 0.9, beta2 0.999, eps 1e-8, bias-corrected moments);
the learning rate ``rate * exp(-iter / decay)`` is carried as state and
multiplied by exp(-1/decay) after every applied step.  The fused segment
kernel (``ops.mega``) shares this state type.  ``make_throughput_runner``
is the fixed-count loop of the measurement programs: the same Adam with
no convergence test and no read from the device.

``batched_adam_update`` is the same Adam for a population of seeds (the
batch layer's per-iteration backends): qoc_tpu vmaps
``make_adam_optimizer``'s optax chain (``scale_by_adam`` with its count,
the carried learning rate, the scale by -1) over the seed axis and masks
the update of frozen seeds (qoc_tpu/parallel/batch.py:221-230); here the
seed axis is written out.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.profiling import span
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


class BatchAdamState(NamedTuple):
    """Per-seed optax Adam state: the leaves of qoc_tpu's vmapped
    (ScaleByAdamState(count, mu, nu), {"lr": lr}, EmptyState())."""

    mu: torch.Tensor       # [S, K, T] first moment
    nu: torch.Tensor       # [S, K, T] second moment
    count: torch.Tensor    # [S] int32 applied updates
    lr: torch.Tensor       # [S] float32 learning rate


def init_batch_adam(u_bases: torch.Tensor,
                    conv: ConvergenceSettings) -> BatchAdamState:
    S = u_bases.shape[0]
    return BatchAdamState(
        mu=torch.zeros_like(u_bases), nu=torch.zeros_like(u_bases),
        count=torch.zeros(S, dtype=torch.int32, device=u_bases.device),
        lr=torch.full((S,), float(np.float32(conv.rate)),
                      dtype=u_bases.dtype, device=u_bases.device))


def batched_adam_update(u: torch.Tensor, state: BatchAdamState,
                        g: torch.Tensor, frozen: torch.Tensor,
                        factor: float):
    """One optax Adam step per seed; a seed with ``frozen`` [S] set keeps
    u, mu, nu, its count and its learning rate.  ``factor`` is the
    learning-rate decay exp(-1/decay).  Returns (u, state)."""
    count = state.count + 1
    mu = (1.0 - B1) * g + B1 * state.mu
    nu = (1.0 - B2) * (g * g) + B2 * state.nu
    bc1 = (1.0 - B1 ** count.to(u.dtype))[:, None, None]
    bc2 = (1.0 - B2 ** count.to(u.dtype))[:, None, None]
    upd = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
    u_new = u - state.lr[:, None, None] * upd
    keep = frozen[:, None, None]
    return (torch.where(keep, u, u_new),
            BatchAdamState(
                mu=torch.where(keep, state.mu, mu),
                nu=torch.where(keep, state.nu, nu),
                count=torch.where(frozen, state.count, count),
                lr=torch.where(frozen, state.lr, state.lr * factor)))


def _adam_step(s: AdamState, g: torch.Tensor, factor) -> dict:
    """TF1 Adam on ``s`` with gradient ``g``: the fields of the state after
    one applied step (u_base, m, v, lr times ``factor``, iteration + 1).
    Pure device arithmetic: nothing is read back to the host."""
    count = s.iteration + 1
    m = B1 * s.m + (1.0 - B1) * g
    v = B2 * s.v + (1.0 - B2) * (g * g)
    m_hat = m / (1.0 - B1 ** count)
    v_hat = v / (1.0 - B2 ** count)
    u_new = s.u_base - s.lr * (m_hat / (torch.sqrt(v_hat) + EPS))
    return dict(u_base=u_new.detach(), m=m, v=v,
                lr=float(np.float32(s.lr) * factor), iteration=count)


def _value_and_grad(loss_fn: Callable, u_base: torch.Tensor):
    u = u_base.detach().requires_grad_(True)
    reg_loss, out = loss_fn(u)
    (g,) = torch.autograd.grad(reg_loss, u)
    return reg_loss, out, g


def decay_factor(conv: ConvergenceSettings) -> float:
    """exp(-1/decay): the learning rate's factor after each applied
    step."""
    return float(np.exp(-1.0 / float(conv.learning_rate_decay)))


def _decay_factor(conv: ConvergenceSettings):
    """``decay_factor`` in float32, as the single-problem runners carry
    the learning rate."""
    return np.float32(decay_factor(conv))


def make_segment_runner(loss_fn: Callable, conv: ConvergenceSettings):
    """``run_segment(state, stop_at)``: iterate until converged or
    ``state.iteration == stop_at``.  ``loss_fn(u_base) -> (reg_loss,
    ForwardOutput)``."""
    factor = _decay_factor(conv)

    def run_segment(state: AdamState, stop_at: int) -> AdamState:
        s = state
        while not s.done and s.iteration < stop_at:
            with span("qoc.step.grad"):
                reg_loss, out, g = _value_and_grad(loss_fn, s.u_base)
            with span("qoc.step.read"):
                g2 = float(0.5 * torch.sum(g * g))
                loss = float(out.loss.detach())
                metrics = dict(loss=loss, reg_loss=float(reg_loss.detach()),
                               grad_squared=g2,
                               unitary_scale=float(
                                   out.unitary_scale.detach()))
            converged = (loss < conv.conv_target or g2 < conv.min_grad
                         or s.iteration >= conv.max_iterations)
            if converged:
                s = s._replace(done=True, **metrics)
                break
            with span("qoc.step.update"):
                s = s._replace(**_adam_step(s, g, factor), **metrics)
        return s

    return run_segment


def make_throughput_runner(loss_fn: Callable, conv: ConvergenceSettings):
    """``run_n(state, n)``: exactly ``n`` iterations of value-and-grad plus
    Adam, for timing (qoc_tpu's ``make_throughput_runner``, a fixed-count
    ``fori_loop``).  No convergence test and no read from the device, so
    the launches of all ``n`` iterations queue; the state's metrics
    (loss, reg_loss, grad_squared, unitary_scale, done) are left as they
    were.  The same Adam arithmetic as ``make_segment_runner``, so both
    give the same pulses where the segment runner does not converge."""
    factor = _decay_factor(conv)

    def run_n(state: AdamState, n: int) -> AdamState:
        s = state
        for _ in range(int(n)):
            _, _, g = _value_and_grad(loss_fn, s.u_base)
            s = s._replace(**_adam_step(s, g, factor))
        return s

    return run_n
