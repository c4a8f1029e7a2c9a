"""Explicit SPMD batched optimization (port of ``qoc_tpu.parallel.shard``).

qoc_tpu's ``shard_map`` step: each device owns a shard of the seed axis,
runs the per-seed Adam step on its local seeds only (seeds are
independent, so the hot loop sends nothing), and the aggregate statistics
(global best loss, mean, converged count, gradient norm) are reduced over
the mesh at the end of the call.  Here each rank of the mesh is one
process: the step is the lean forward under ``torch.func.vmap(grad)`` and
the batched Adam with no freezing, and the statistics are two
``all_reduce`` calls (MIN for the best loss, SUM for the rest).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..interop import entry_device
from ..models.forward import make_forward
from ..optim.adam import (batched_adam_update, decay_factor,
                          init_batch_adam)
from ..optim.convergence import ConvergenceSettings
from .mesh import all_reduce, local_shard


class ShardedStats(NamedTuple):
    """Statistics reduced over the mesh (the same on every rank)."""

    best_loss: torch.Tensor    # global min fidelity loss
    mean_loss: torch.Tensor    # global mean
    n_converged: torch.Tensor  # global count of seeds below conv_target
    grad_norm: torch.Tensor    # global l2 norm of all per-seed gradients


def make_shard_map_step(problem, conv: ConvergenceSettings, mesh,
                        reg_coeffs: Optional[dict] = None,
                        engine: str = "scan", steps_per_call: int = 1,
                        device=None):
    """Build ``(init, step)``.

    ``init(u_bases [S, K, T])`` takes the global seed batch (S a multiple
    of the mesh size) and returns this rank's ``(u, opt_state)``;
    ``step(u, opt_state) -> (u, opt_state, ShardedStats)`` advances the
    local seeds ``steps_per_call`` Adam iterations with no collective, then
    reduces the statistics of the last iteration's metrics (taken at its
    pre-update iterate) over the mesh.  ``device=None`` means the CUDA
    card."""
    device = entry_device(device)
    _, loss_fn = make_forward(problem, reg_coeffs=reg_coeffs, engine=engine,
                              lean=True, device=device)
    factor = decay_factor(conv)

    def seed_loss(u):
        reg_loss, out = loss_fn(u)
        return reg_loss, out.loss

    v_grad = torch.func.vmap(torch.func.grad_and_value(seed_loss,
                                                       has_aux=True))

    def init(u_bases):
        u = torch.as_tensor(local_shard(u_bases, mesh), dtype=torch.float32,
                            device=device)
        return u, init_batch_adam(u, conv)

    def step(u, opt_state):
        keep = torch.zeros(u.shape[0], dtype=torch.bool, device=device)
        for _ in range(max(int(steps_per_call), 1)):
            grads, (_, losses) = v_grad(u)
            u, opt_state = batched_adam_update(u, opt_state, grads, keep,
                                               factor)
        best = all_reduce(torch.min(losses), mesh, dist.ReduceOp.MIN)
        total, count, n_conv, gsq = all_reduce(torch.stack([
            torch.sum(losses),
            torch.tensor(float(losses.shape[0]), device=device),
            torch.sum((losses < conv.conv_target).to(torch.float32)),
            torch.sum(grads * grads)]), mesh)
        return u, opt_state, ShardedStats(best, total / count, n_conv,
                                          torch.sqrt(gsq))

    return init, step
