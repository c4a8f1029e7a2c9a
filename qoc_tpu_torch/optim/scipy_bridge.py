"""scipy.optimize bridge for BFGS / L-BFGS-B (port of
``qoc_tpu.optim.scipy_bridge``; parity with run_session.py:119-196).

Each probe is one loss-and-gradient through ``torch.autograd`` on the
problem's device; the weights go up once per probe and the result comes
back in one device-to-host copy, a packed float32 vector [grad (K*T),
loss, reg_loss, unitary_scale].

Reference semantics kept:
  * options {maxfun: max_iterations, gtol: min_grad, maxls: 40} for
    L-BFGS-B and {maxiter: max_iterations, gtol: min_grad, disp: False}
    for BFGS (run_session.py:181);
  * on reaching conv_target the gradient is zeroed to force scipy's
    termination (run_session.py:155-160);
  * L-BFGS-B gets float64 returns (run_session.py:164-165);
  * the callback runs once per function evaluation, with its counter;
  * grad^2 = 0.5 |g|^2 in float64 from the host gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from scipy.optimize import minimize

from .convergence import ConvergenceSettings


def run_scipy_optimizer(
    loss_fn: Callable,
    u0_base: np.ndarray,
    conv: ConvergenceSettings,
    method: str = "L-BFGS-B",
    callback: Optional[Callable] = None,
    device="cpu",
):
    """Minimize reg_loss over the base weights with a scipy optimizer.

    ``loss_fn(u_base) -> (reg_loss, ForwardOutput)`` on ``device``.
    ``callback(iteration, loss, reg_loss, grad_squared, unitary_scale,
    u_base)`` is invoked once per function evaluation.

    Returns (u_base_opt [K, T], scipy_result).
    """
    shape = np.shape(u0_base)
    n = int(np.prod(shape))
    device = torch.device(device)
    lbfgsb = method.upper() == "L-BFGS-B"
    state = {"iterations": 0}

    def fun(x):
        u_host = np.asarray(x, dtype=np.float32).reshape(shape)
        u = torch.from_numpy(u_host).to(device).requires_grad_(True)
        reg_loss, out = loss_fn(u)
        (g,) = torch.autograd.grad(reg_loss, u)
        packed = torch.cat([g.reshape(-1), torch.stack(
            [out.loss, reg_loss, out.unitary_scale]).detach()])
        packed = packed.cpu().numpy()
        g = packed[:n].astype(np.float64)
        loss, rl, uscale = (float(v) for v in packed[n:])
        g2 = 0.5 * float(np.sum(g * g))
        if loss < conv.conv_target:
            g = 0.0 * g   # zero grads to terminate scipy (run_session.py:160)
        if callback is not None:
            callback(state["iterations"], loss, rl, g2, uscale, u_host)
        state["iterations"] += 1
        if lbfgsb:
            return np.float64(rl), g
        return rl, g

    if lbfgsb:
        options = {"maxfun": conv.max_iterations, "gtol": conv.min_grad,
                   "maxls": 40}
    else:
        options = {"maxiter": conv.max_iterations, "gtol": conv.min_grad,
                   "disp": False}
    res = minimize(fun, np.asarray(u0_base, dtype=np.float64).ravel(),
                   method=method, jac=True, options=options)
    u_opt = np.asarray(res["x"], dtype=np.float32).reshape(shape)
    return u_opt, res
