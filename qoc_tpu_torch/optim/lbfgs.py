"""Native L-BFGS driver (port of ``qoc_tpu.optim.lbfgs``).

qoc_tpu runs ``optax.lbfgs(memory_size=15)``: ``scale_by_lbfgs`` (the
two-loop recursion over a ring buffer of parameter and gradient
differences, with the scaled-identity initial preconditioner), a scale by
-1, then ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`` (Nocedal and Wright's algorithms 3.5 and
3.6 with Hager and Zhang's approximate-decrease test), and reuses the
accepted linesearch point's value and gradient through
``optax.value_and_grad_from_state``.  The card's machine has no optax, so
the algorithm is written out here in torch, with optax 0.2.6's constants,
safeguards and failure handling.

The optimization is a plain Python loop.  The direction stays on the
device; each linesearch probe is one loss-and-gradient and one read of
(value, slope) to the host, where the linesearch decides in the
parameters' float type.

The loop is qoc_tpu's (lbfgs.py:62-117): the convergence test (objective
< conv_target, 0.5 |g|^2 < min_grad, iteration >= max_iterations) comes
before the update, on the cached value and gradient; a converged state
keeps its iterate; ``loss`` and ``reg_loss`` hold the objective inside a
segment, and one aux forward at each segment boundary gives the fidelity
loss and unitary_scale, followed by the ``done`` test on them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .convergence import ConvergenceSettings

MEMORY_SIZE = 15
MAX_LINESEARCH_STEPS = 20
# scale_by_zoom_linesearch's defaults (optax/_src/linesearch.py:1331-1342)
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5


class LbfgsMemory(NamedTuple):
    """``ScaleByLBFGSState`` plus the linesearch's cached point."""

    count: int                    # directions computed so far
    params: torch.Tensor          # parameters at the last direction
    updates: torch.Tensor         # gradient at the last direction
    diff_params: torch.Tensor     # [m, ...] ring buffer of s_k
    diff_updates: torch.Tensor    # [m, ...] ring buffer of y_k
    weights: torch.Tensor         # [m] rho_k = 1 / <y_k, s_k> (0: empty)
    value: float                  # the accepted point's value (inf: none)
    grad: Optional[torch.Tensor]  # the accepted point's gradient


def init_memory(params: torch.Tensor,
                memory_size: int = MEMORY_SIZE) -> LbfgsMemory:
    zeros = torch.zeros((memory_size,) + tuple(params.shape),
                        dtype=params.dtype, device=params.device)
    return LbfgsMemory(
        count=0, params=torch.zeros_like(params),
        updates=torch.zeros_like(params), diff_params=zeros,
        diff_updates=zeros.clone(),
        weights=torch.zeros(memory_size, dtype=params.dtype,
                            device=params.device),
        value=float("inf"), grad=None)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def lbfgs_direction(grad: torch.Tensor, params: torch.Tensor,
                    mem: LbfgsMemory):
    """``scale_by_lbfgs``'s update (transform.py:1685-1752): store the new
    difference pair, then the two-loop recursion P_k g.  Returns (P_k g,
    memory); all on the device."""
    m = mem.weights.shape[0]
    idx = mem.count % m
    prev = (mem.count - 1) % m
    diff_params = mem.diff_params.clone()
    diff_updates = mem.diff_updates.clone()
    weights = mem.weights.clone()
    if mem.count > 0:
        dp = params - mem.params
        du = grad - mem.updates
        vd = _vdot(du, dp)
        weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
        den = _vdot(du, du)
        scale = torch.where(den > 0.0, vd / den, torch.ones_like(den))
    else:
        dp = torch.zeros_like(params)
        du = torch.zeros_like(grad)
        weight = torch.zeros((), dtype=grad.dtype, device=grad.device)
        # the first step: a capped reciprocal of the gradient norm
        scale = torch.clamp(1.0 / torch.sqrt(_vdot(grad, grad)), max=1.0)
    diff_params[prev] = dp
    diff_updates[prev] = du
    weights[prev] = weight

    # slots not written yet hold zeros and contribute exactly nothing
    filled = min(mem.count + 1, m)
    order = [(idx + j) % m for j in range(m)][m - filled:]
    vec = grad
    alphas = []
    for i in reversed(order):
        alpha = weights[i] * _vdot(diff_params[i], vec)
        vec = vec + (-alpha) * diff_updates[i]
        alphas.append(alpha)
    vec = scale * vec
    for i, alpha in zip(order, reversed(alphas)):
        beta = weights[i] * _vdot(diff_updates[i], vec)
        vec = vec + (alpha - beta) * diff_params[i]
    return vec, mem._replace(
        count=mem.count + 1, params=params, updates=grad,
        diff_params=diff_params, diff_updates=diff_updates, weights=weights)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (linesearch.py:455-493); NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    x1 = fb - fa - C * db
    x2 = fc - fa - C * dc
    A = (dc ** 2 * x1 + -(db ** 2) * x2) / denom
    B = (-(dc ** 3) * x1 + db ** 3 * x2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (linesearch.py:496-522)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _Probe(NamedTuple):
    stepsize: object
    value: object
    grad: torch.Tensor
    slope: object


def zoom_linesearch(value_and_grad: Callable, params: torch.Tensor,
                    updates: torch.Tensor, value, grad: torch.Tensor,
                    max_steps: int = MAX_LINESEARCH_STEPS):
    """``zoom_linesearch`` with ``max_stepsize=None``, ``tol=0`` and the
    initial guess 1 (linesearch.py:576-1282): the interval search, then
    the zoom by cubic, quadratic or bisection steps, keeping the best
    point of sufficient decrease as the safeguard returned when the
    search fails.  ``value_and_grad(x) -> (value tensor, grad)``.
    Returns (stepsize, value, grad, probes, failed)."""
    f = np.float64 if params.dtype == torch.float64 else np.float32
    inf = f(np.inf)

    def probe(stepsize) -> _Probe:
        step = params + float(stepsize) * updates
        v, g = value_and_grad(step)
        vs = torch.stack([v.reshape(()).to(g.dtype), _vdot(g, updates)])
        v_host, s_host = vs.tolist()
        return _Probe(f(stepsize), f(v_host), g, f(s_host))

    value_init = f(value)
    slope_init = f(_vdot(updates, grad).item())

    def decrease_error(p: _Probe):
        err = p.value - value_init - f(SLOPE_RTOL) * p.stepsize * slope_init
        approx = p.slope - f(2 * SLOPE_RTOL - 1.0) * slope_init
        delta = p.value - value_init - f(APPROX_DEC_RTOL) * abs(value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, f(0.0))
        return inf if np.isnan(err) else err

    def curvature_error(p: _Probe):
        err = np.maximum(abs(p.slope) - f(CURV_RTOL) * abs(slope_init),
                         f(0.0))
        return inf if np.isnan(err) else err

    cur = _Probe(f(0.0), value_init, grad, slope_init)
    low = high = cubic_ref = cur
    safe = cur
    dec_err = inf
    interval_found = done = failed = False
    count = 0
    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                # the interval search (algorithm 3.5)
                new = probe(f(1.0) if count == 0
                            else f(INCREASE_FACTOR) * cur.stepsize)
                dec_err = decrease_error(new)
                err = max(dec_err, curvature_error(new))
                if dec_err <= 0.0:
                    safe = new
                set_high = dec_err > 0.0 or (new.value >= cur.value
                                             and count > 0)
                set_low = new.slope >= 0.0 and not set_high
                if set_low:
                    low, high = new, cur
                else:
                    low, high = cur, new
                cubic_ref = low
                interval_found = set_high or set_low or err <= 0.0
                done = err <= 0.0
                failed = count + 1 >= max_steps and not done
            else:
                # the zoom (algorithm 3.6)
                delta = abs(high.stepsize - low.stepsize)
                left = min(high.stepsize, low.stepsize)
                right = max(high.stepsize, low.stepsize)
                too_small = delta <= INTERVAL_THRESHOLD
                mid_cubic = _cubicmin(low.stepsize, low.value, low.slope,
                                      high.stepsize, high.value,
                                      cubic_ref.stepsize, cubic_ref.value)
                mid_quad = _quadmin(low.stepsize, low.value, low.slope,
                                    high.stepsize, high.value)
                if (left + f(0.2) * delta < mid_cubic
                        < right - f(0.2) * delta):
                    middle = mid_cubic
                elif left + f(0.1) * delta < mid_quad < right - f(0.1) * delta:
                    middle = mid_quad
                else:
                    middle = (low.stepsize + high.stepsize) / f(2.0)
                new = probe(middle)
                dec_err = decrease_error(new)
                err = max(dec_err, curvature_error(new))
                if dec_err <= 0.0 and new.value < safe.value:
                    safe = new
                done = err <= 0.0
                set_high_mid = dec_err > 0.0 or new.value >= low.value
                set_high_low = (new.slope * (high.stepsize - low.stepsize)
                                >= 0.0 and not set_high_mid)
                old_low, old_high = low, high
                if set_high_mid:
                    high = new
                if set_high_low:
                    high = old_low
                if not set_high_mid:
                    low = new
                cubic_ref = (old_high if set_high_mid or set_high_low
                             else old_low)
                failed = ((count + 1 >= max_steps
                           or (too_small and safe.stepsize > 0.0))
                          and not done)
            cur = new
            count += 1
            if failed and (safe.stepsize > 0.0 or np.isinf(dec_err)):
                # the safeguard (_try_safe_step)
                cur = safe
    return cur.stepsize, cur.value, cur.grad, count, failed


class LbfgsState(NamedTuple):
    u_base: torch.Tensor
    memory: LbfgsMemory
    iteration: int
    loss: float
    reg_loss: float
    grad_squared: float
    unitary_scale: float
    done: bool
    evaluations: int     # loss-and-gradient evaluations so far


def make_lbfgs_runner(loss_fn: Callable, conv: ConvergenceSettings,
                      memory_size: int = MEMORY_SIZE):
    """(init_state, run_segment) mirroring the Adam driver's API.

    ``loss_fn(u_base) -> (reg_loss, ForwardOutput)``.  ``run_segment(state,
    stop_at)`` iterates until converged or ``state.iteration == stop_at``,
    then runs the aux forward.  One loss-and-gradient per linesearch
    probe; the accepted probe's value and gradient serve the next
    iteration's convergence test and direction.
    """
    counter = {"n": 0}

    def value_and_grad(u: torch.Tensor):
        u = u.detach().requires_grad_(True)
        reg_loss, _ = loss_fn(u)
        (g,) = torch.autograd.grad(reg_loss, u)
        counter["n"] += 1
        return reg_loss.detach(), g

    def run_segment(state: LbfgsState, stop_at: int) -> LbfgsState:
        s = state
        counter["n"] = s.evaluations
        while not s.done and s.iteration < stop_at:
            mem = s.memory
            if np.isfinite(mem.value):
                value, grad = mem.value, mem.grad
                g2 = float(0.5 * torch.sum(grad * grad))
            else:
                v, grad = value_and_grad(s.u_base)
                value, g2 = torch.stack(
                    [v.to(grad.dtype), 0.5 * torch.sum(grad * grad)]).tolist()
            converged = (value < conv.conv_target or g2 < conv.min_grad
                         or s.iteration >= conv.max_iterations)
            metrics = dict(loss=value, reg_loss=value, grad_squared=g2)
            if converged:
                s = s._replace(done=True, **metrics)
                break
            direction, mem = lbfgs_direction(grad, s.u_base, mem)
            updates = -direction
            step, v_new, g_new, _, _ = zoom_linesearch(
                value_and_grad, s.u_base, updates, value, grad)
            u_new = s.u_base + float(step) * updates
            s = s._replace(
                u_base=u_new.detach(),
                memory=mem._replace(value=float(v_new), grad=g_new),
                iteration=s.iteration + 1, evaluations=counter["n"],
                **metrics)
        # aux metrics once per segment: one forward at the current iterate
        with torch.no_grad():
            reg_loss, out = loss_fn(s.u_base)
            loss, reg, uscale = torch.stack(
                [out.loss, reg_loss, out.unitary_scale]).tolist()
        done = (s.done or loss < conv.conv_target
                or s.grad_squared < conv.min_grad
                or s.iteration >= conv.max_iterations)
        return s._replace(loss=loss, reg_loss=reg, unitary_scale=uscale,
                          done=done, evaluations=counter["n"])

    def init_state(u_base: torch.Tensor) -> LbfgsState:
        u = u_base.detach().clone()
        inf = float("inf")
        return LbfgsState(
            u_base=u, memory=init_memory(u, memory_size), iteration=0,
            loss=inf, reg_loss=inf, grad_squared=inf, unitary_scale=0.0,
            done=False, evaluations=0)

    return init_state, run_segment
