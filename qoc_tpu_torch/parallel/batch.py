"""Seed-batched GRAPE: many seeds and Hamiltonian sweeps per step (port of
``qoc_tpu.parallel.batch``).

GRAPE lands in local optima, so users restart from many random pulses;
this layer optimizes them together.  Each seed keeps its own Adam state
and its own convergence flag: a converged seed freezes while the rest of
the batch keeps stepping.  Four backends (``backend=``), as in qoc_tpu:

  * ``"mega"``: the fused batched-optimizer kernel
    (``parallel.mega_batch``, kernel 6): whole Adam segments per launch
    with in-kernel per-seed freezing and all seven penalties;
  * ``"pallas"``: the fused state chain per loss evaluation
    (``parallel.chain_batch``, kernels 4 and 5), torch Adam around it;
  * ``"xla-cols"``: the column-batched torch chain
    (``parallel.cols_batch``): any V, all seven penalties, large dims;
  * ``"xla"``: the per-seed lean forward, vmapped with ``torch.func``;
    the only backend for per-seed generator stacks (``mats_batch``).

``"auto"`` takes mega, else pallas, else xla-cols on a CUDA device (each
when its gate holds, with exact gradients and no ``mats_batch``), and
xla otherwise (qoc_tpu/parallel/batch.py:147-172).  On the CPU the kernel
backends run their plain torch versions.

``mesh=`` (``parallel.mesh``) shards the seed axis over the ranks of a
process group, one device each, on any backend: every rank draws the same
global seed batch, keeps its shard and runs it with no collective inside a
segment.  After each ``update_step`` segment one ``all_reduce`` gives the
global iteration (the MAX over ranks: a rank whose seeds are all frozen
stops stepping, and a frozen seed's metrics do not change) and the global
``all(done)``.  qoc_tpu's while_loop reduces ``any(~done)`` every
iteration instead; the results are the unsharded run's either way.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..interop import entry_device
from ..models.costs import cost_names, validate_reg_coeffs
from ..models.forward import make_forward
from ..optim.adam import (BatchAdamState, batched_adam_update, decay_factor,
                          init_batch_adam)
from ..optim.convergence import ConvergenceSettings
from ..routing import announce, fused_fallback_reasons
from ..utils.profiling import span
from .chain_batch import make_pallas_batched_loss, pallas_batch_supported
from .cols_batch import make_xla_batched_loss, xla_cols_supported
from .mega_batch import batched_mega_supported, make_mega_batched_runner
from .mesh import all_reduce, gather, local_shard


class BatchState(NamedTuple):
    u_base: torch.Tensor       # [S, K, T]
    opt_state: object          # BatchAdamState; MegaBatchState for "mega"
    iteration: int             # global iteration counter
    loss: torch.Tensor         # [S]
    reg_loss: torch.Tensor     # [S]
    grad_squared: torch.Tensor  # [S]
    done: torch.Tensor         # [S] bool
    # under a mesh: the seed fields hold this rank's shard, and all_done
    # is the global all(done) after a segment
    all_done: Optional[bool] = None


def init_seeds(problem, n_seeds: int, generator: torch.Generator,
               device="cpu") -> torch.Tensor:
    """Per-seed random initial pulses [S, K, T], stddev 1/sqrt(steps)
    (system_parameters.py:278-282): ``torch.randn`` from ``generator`` on
    the CPU, then moved to ``device``, so one seed gives the same pulses on
    any device.  The draws are not qoc_tpu's (``jax.random``)."""
    u = torch.randn((n_seeds, problem.ops_len, problem.steps),
                    generator=generator, dtype=torch.float32)
    return (u / np.sqrt(problem.steps)).to(device)


def describe_backend(backend: str, device: torch.device,
                     reg_coeffs: Optional[dict] = None) -> str:
    """The routing line's name of a backend on ``device``."""
    cuda = device.type == "cuda"
    if backend == "mega":
        names = cost_names(reg_coeffs)
        return "mega ({}{})".format(
            "fused batched-optimizer CUDA kernel" if cuda
            else "plain torch batched segment on cpu",
            ", penalties: " + ", ".join(names) if names else "")
    return {
        "pallas": ("pallas (fused state-chain CUDA kernel + autograd "
                   "backward)" if cuda
                   else "pallas (plain torch state chain on cpu)"),
        "xla-cols": "xla-cols (column-batched torch chain)",
        "xla": "xla (vmapped generic forward)",
    }.get(backend, backend)


def _make_mega_backend(problem, conv, extra_channel_mats, reg_coeffs,
                       device):
    """(init_state, run_segment): the fused batched-optimizer kernel behind
    the BatchState protocol."""
    init_m, run_m, _ = make_mega_batched_runner(
        problem, conv, extra_channel_mats=extra_channel_mats,
        reg_coeffs=reg_coeffs, device=device)

    def init_state(u_bases) -> BatchState:
        u = torch.as_tensor(u_bases, dtype=torch.float32, device=device)
        S = u.shape[0]
        inf = torch.full((S,), float("inf"), device=device)
        return BatchState(u_base=u, opt_state=init_m(u), iteration=0,
                          loss=inf, reg_loss=inf, grad_squared=inf,
                          done=torch.zeros(S, dtype=torch.bool,
                                           device=device))

    def run_segment(state: BatchState, stop_at, mats_b) -> BatchState:
        n = int(stop_at) - state.iteration
        if n <= 0:
            return state
        ms = run_m(state.opt_state, n, extra_weights=mats_b)
        V = ms.u_cols.shape[2] // state.u_base.shape[0]
        return BatchState(
            u_base=ms.u_cols[:, :, ::V].permute(2, 1, 0), opt_state=ms,
            iteration=ms.iteration, loss=ms.losses, reg_loss=ms.reg_losses,
            grad_squared=ms.grad_squared, done=ms.done_cols[0, ::V] > 0.5)

    return init_state, run_segment


def _sharded_runner(init_state, run_segment, mesh):
    """The runner on this rank's shard of the seed axis: ``init_state`` and
    ``run_segment`` take the global pulses and ``mats_b`` and keep the
    rank's slice; one ``all_reduce`` per segment sets the global iteration
    (MAX) and ``all_done``."""
    def init_sharded(u_bases) -> BatchState:
        return init_state(local_shard(u_bases, mesh))

    def run_sharded(state: BatchState, stop_at, mats_b) -> BatchState:
        s = state
        if not bool(torch.all(s.done)):
            s = run_segment(s, stop_at, None if mats_b is None
                            else local_shard(mats_b, mesh))
        it, live = all_reduce(
            torch.tensor([s.iteration, int(not bool(torch.all(s.done)))]),
            mesh, torch.distributed.ReduceOp.MAX).tolist()
        return s._replace(iteration=it, all_done=not live)

    return init_sharded, run_sharded


def make_batched_runner(problem, conv: ConvergenceSettings,
                        reg_coeffs: Optional[dict] = None,
                        gradient_mode: str = "exact", engine: str = "auto",
                        remat: bool = False, sweep_mats: bool = False,
                        mesh=None, backend: str = "auto",
                        extra_channel_mats=None, device=None):
    """(init_state, run_segment) for S-way batched Adam.

    ``run_segment(state, stop_at, mats_b)`` iterates until every seed is
    frozen or the global iteration reaches ``stop_at``.  ``mats_b`` is
    the per-seed generator stack [S, K+1, M, M] with ``sweep_mats``, the
    extra channels' weights [S, E] with ``extra_channel_mats``, else None.
    ``remat`` recomputes the "xla" backend's propagators in the backward
    pass; "xla-cols" always does (qoc_tpu's default).  With ``mesh`` both
    functions take global arrays and the state holds this rank's shard.
    """
    device = entry_device(device)
    on_accel = device.type == "cuda"
    if backend == "auto":
        fused = on_accel and gradient_mode == "exact" and not sweep_mats
        if fused and batched_mega_supported(problem, reg_coeffs):
            backend = "mega"
        elif fused and pallas_batch_supported(problem, reg_coeffs):
            backend = "pallas"
        elif fused and xla_cols_supported(problem, reg_coeffs):
            backend = "xla-cols"
        else:
            backend = "xla"
        reasons = None
        if backend != "mega":
            reasons = fused_fallback_reasons(
                problem, reg_coeffs, gradient_mode=gradient_mode,
                sweep_mats=sweep_mats, on_accel=on_accel)
        announce("batch backend",
                 describe_backend(backend, device, reg_coeffs), reasons)
    else:
        announce("batch backend",
                 describe_backend(backend, device, reg_coeffs) + " (forced)")

    if backend == "mega":
        init_state, run_segment = _make_mega_backend(
            problem, conv, extra_channel_mats, reg_coeffs, device)
    else:
        init_state, run_segment = _make_per_iteration_backend(
            problem, conv, reg_coeffs, gradient_mode, engine, remat,
            sweep_mats, backend, extra_channel_mats, device)
    if mesh is None:
        return init_state, run_segment
    return _sharded_runner(init_state, run_segment, mesh)


def _make_per_iteration_backend(problem, conv, reg_coeffs, gradient_mode,
                                engine, remat, sweep_mats, backend,
                                extra_channel_mats, device):
    """(init_state, run_segment) of the "pallas", "xla-cols" and "xla"
    backends: a loss-and-gradient, the predicates and a masked Adam step
    per iteration."""
    if backend in ("pallas", "xla-cols"):
        make = (make_pallas_batched_loss if backend == "pallas"
                else make_xla_batched_loss)
        batched_loss = make(problem, reg_coeffs,
                            extra_channel_mats=extra_channel_mats,
                            device=device)

        def batch_metrics(u_bases, mats_b):
            u = u_bases.detach().requires_grad_(True)
            reg_losses, fid_losses = batched_loss(u, mats_b)
            (grads,) = torch.autograd.grad(reg_losses.sum(), u)
            g2 = 0.5 * torch.sum(grads * grads, dim=(1, 2))
            return fid_losses.detach(), reg_losses.detach(), g2, grads
    else:
        # the per-seed forward vmapped: the serial scan is the engine that
        # vmaps (the fused kernels pack their own batch axis)
        _, loss_fn = make_forward(
            problem, reg_coeffs=reg_coeffs, gradient_mode=gradient_mode,
            engine="scan" if engine == "auto" else engine, lean=True,
            remat=remat, device=device)

        def seed_loss(u_base, mats_in):
            reg_loss, out = loss_fn(u_base, mats_in)
            return reg_loss, out.loss

        def seed_metrics(u_base, mats_in):
            grads, (reg_loss, loss) = torch.func.grad_and_value(
                seed_loss, has_aux=True)(u_base, mats_in)
            return loss, reg_loss, 0.5 * torch.sum(grads * grads), grads

        batch_metrics = torch.func.vmap(
            seed_metrics, in_dims=(0, 0 if sweep_mats else None))

    factor = decay_factor(conv)

    def init_state(u_bases) -> BatchState:
        u = torch.as_tensor(u_bases, dtype=torch.float32, device=device)
        S = u.shape[0]
        inf = torch.full((S,), float("inf"), device=device)
        return BatchState(u_base=u, opt_state=init_batch_adam(u, conv),
                          iteration=0, loss=inf, reg_loss=inf,
                          grad_squared=inf,
                          done=torch.zeros(S, dtype=torch.bool,
                                           device=device))

    def run_segment(state: BatchState, stop_at, mats_b) -> BatchState:
        """Metrics at the current iterate, then the predicates, then the
        masked update (qoc_tpu/parallel/batch.py:250-268)."""
        s = state
        while s.iteration < int(stop_at):
            with span("qoc.step.read"):
                if bool(torch.all(s.done)):
                    break
            with span("qoc.step.grad"):
                loss, reg_loss, g2, grads = batch_metrics(s.u_base, mats_b)
            with span("qoc.step.update"):
                converged = ((loss < conv.conv_target)
                             | (g2 < conv.min_grad)
                             | (s.iteration >= conv.max_iterations) | s.done)
                u, opt = batched_adam_update(s.u_base, s.opt_state, grads,
                                             converged, factor)
            s = BatchState(u.detach(), opt, s.iteration + 1, loss.detach(),
                           reg_loss.detach(), g2.detach(), converged)
        return s

    return init_state, run_segment


def batched_grape_adam(problem, n_seeds: int,
                       convergence: Optional[dict] = None,
                       reg_coeffs: Optional[dict] = None, seed: int = 0,
                       mesh=None, mats_batch=None,
                       gradient_mode: str = "exact", engine: str = "auto",
                       backend: str = "auto", extra_channels=None,
                       progress: Optional[Callable] = None, device=None):
    """Optimize ``n_seeds`` independent pulse initializations in parallel.

    Returns qoc_tpu's result dict: per-seed losses, reg_losses and
    pulses, the iteration count, the converged flags and the best seed's
    physical pulse.  ``device=None`` means the CUDA card (and raises
    when torch sees none); ``device="cpu"`` runs the plain versions.
    With ``mesh`` the seed axis is sharded over the mesh's ranks, and
    every rank returns the global result (``progress`` sees global
    arrays too).

    Hamiltonian sweeps, two mechanisms:
      * ``mats_batch`` ([S, K+1, 2N, 2N]): per-seed generators, "xla";
      * ``extra_channels=(extra_mats [E, 2N, 2N], extra_weights [S, E])``:
        swept terms as fixed operator channels with constant per-seed
        weights, on the fused kernels or xla-cols.
    """
    with span("qoc.batch.front_end"):
        validate_reg_coeffs(reg_coeffs, state_num=problem.state_num)
        conv = ConvergenceSettings.from_dict(convergence)
        device = entry_device(device)
        sweep = mats_batch is not None
        if sweep and extra_channels is not None:
            raise ValueError(
                "pass either mats_batch or extra_channels, not both")
        extra_mats = extra_w = None
        if extra_channels is not None:
            # extra channels ride the fused kernels and the column-batched
            # chain (the vmapped backend has no constant-channel operand)
            extra_mats, extra_w = extra_channels
            if backend == "auto":
                if batched_mega_supported(problem, reg_coeffs):
                    backend = "mega"
                elif pallas_batch_supported(problem, reg_coeffs):
                    backend = "pallas"
                elif xla_cols_supported(problem, reg_coeffs):
                    backend = "xla-cols"
                else:
                    raise ValueError(
                        "extra_channels need a fused or column-batched "
                        "backend; this problem/cost combination supports none")
        init_state, run_segment = make_batched_runner(
            problem, conv, reg_coeffs=reg_coeffs, gradient_mode=gradient_mode,
            engine=engine, sweep_mats=sweep, mesh=mesh, backend=backend,
            extra_channel_mats=extra_mats, device=device)
        u_bases = init_seeds(problem, n_seeds,
                             torch.Generator().manual_seed(int(seed)), device)
        if sweep:
            mats_b = torch.as_tensor(np.asarray(mats_batch, dtype=np.float32),
                                     device=device)
        elif extra_w is not None:
            mats_b = torch.as_tensor(np.asarray(extra_w, dtype=np.float32),
                                     device=device)
        else:
            mats_b = None

        def whole(x):
            """The global array of a per-seed field."""
            return (x if mesh is None else gather(x, mesh)).cpu().numpy()

        state = init_state(u_bases)
    # the loop's span holds the host's moments between the segments' and
    # the boundaries' spans, as in ``Grape``
    with span("qoc.batch.loop"):
        while True:
            stop_at = min(state.iteration + conv.update_step,
                          conv.max_iterations + 1)
            with span("qoc.batch.segment"):
                state = run_segment(state, stop_at, mats_b)
                # the first read of the segment's results: it waits for the
                # card (kernel 6 returns at its launch)
                all_done = (bool(torch.all(state.done)) if mesh is None
                            else state.all_done)
            with span("qoc.batch.boundary"):
                if progress is not None:
                    progress(state.iteration, whole(state.loss),
                             whole(state.done))
            if all_done or state.iteration > conv.max_iterations:
                break

    with span("qoc.batch.readout"):
        losses = whole(state.loss)
        best = int(np.argmin(losses))
        u_base = whole(state.u_base)
        max_amp = np.asarray(problem.ops_max_amp)[None, :, None]
        uks_all = max_amp * np.sin(u_base)
        return {
            "losses": losses,
            "reg_losses": whole(state.reg_loss),
            "iterations": int(state.iteration),
            "u_base": u_base,
            "uks": uks_all,
            "best_seed": best,
            "best_uks": uks_all[best],
            "best_loss": float(losses[best]),
            "converged": whole(state.done),
        }
