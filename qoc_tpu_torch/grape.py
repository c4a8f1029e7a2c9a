"""Public API: ``Grape(...)`` on PyTorch (port of ``qoc_tpu.grape``).

Same positional arguments, keyword defaults and ``(uks, U_final)`` return
as qoc_tpu's ``Grape`` (and the reference, main_grape/grape.py:19), plus
``device``: where the problem's tensors live.  ``None`` means the CUDA
card and raises when torch sees none; ``device="cpu"`` runs the plain
torch versions on the CPU.

Methods, with qoc_tpu's names: ``"Adam"``; qoc_tpu's native L-BFGS
(``"L-BFGS-JAX"``, ``"LBFGS"`` or ``"LBFGS-JAX"``, ``optim.lbfgs``);
``"BFGS"`` and ``"L-BFGS-B"`` through scipy (``optim.scipy_bridge``);
``"EVOLVE"`` (one forward).  Any other name raises ``ValueError``.
Exact and reference-parity gradients (``gradient_mode``), ``remat`` and
all seven penalties (``reg_coeffs``, ``models.costs``).  On a CUDA device
an Adam run goes through the fused segment kernel (``ops.mega``) whenever
``mega_supported`` holds (``engine="auto"`` or ``"mega"``), else through
the per-iteration runner over the engine qoc_tpu's ladders pick
(``ops.propagation``: ``tree``, ``pscan``, ``associative`` or ``scan``;
each can also be asked for by name); the quasi-Newton methods evaluate
the same per-iteration loss.  On the CPU, ``engine="mega"`` runs the
segment's plain torch version, and everything else runs the plain
engines.

An Adam run that saves writes a checkpoint (``utils.checkpoint``, the
datasets of qoc_tpu's) at every ``update_step`` boundary, and
``resume_from=<run file>`` continues it on either Adam route, from a file
of either package; on ``KeyboardInterrupt`` the run saves its checkpoint
and wall clock and returns the current iterate.  With ``show_plots``
inside IPython each update_step boundary redraws the dashboard
(``utils.plotting.plot_summary``); a headless run, or one without IPython
or matplotlib, prints a progress line there instead.

``GrapeResult.nfev`` counts loss-and-gradient evaluations: scipy's
``nfev`` for BFGS / L-BFGS-B (as in qoc_tpu), and the linesearch's probes
for the native L-BFGS (qoc_tpu leaves it None there).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .interop import entry_device
from .models.costs import cost_names, validate_reg_coeffs
from .models.forward import make_forward
from .models.system import ControlProblem
from .ops.mega import make_mega_segment_runner, mega_supported
from .optim.adam import init_adam_state, make_segment_runner
from .optim.convergence import ConvergenceSettings, History
from .optim.lbfgs import make_lbfgs_runner
from .optim.scipy_bridge import run_scipy_optimizer
from .routing import announce, fused_fallback_reasons
from .utils import analysis as _analysis
from .utils.checkpoint import (checkpoint_leaves, load_checkpoint,
                               save_checkpoint, state_from_leaves)
from .utils.profiling import span


class GrapeResult:
    """Everything a run produced (the reference returns only (uks, Uf))."""

    def __init__(self, uks, Uf, u_base, loss, reg_loss, unitary_scale,
                 iterations, history, file_path, inter_vecs=None, problem=None,
                 nfev=None, fidelity_f64=None, engine=None):
        self.uks = uks
        self.Uf = Uf
        self.u_base = u_base
        self.loss = loss
        self.reg_loss = reg_loss
        self.unitary_scale = unitary_scale
        self.iterations = iterations
        self.history = history
        self.file_path = file_path
        self.inter_vecs = inter_vecs
        self.problem = problem
        # loss-and-gradient evaluations of the quasi-Newton methods (each
        # linesearch probe is one), distinct from ``iterations``
        self.nfev = nfev
        # float64 recompute of the final fidelity (analysis.fidelity_f64)
        self.fidelity_f64 = fidelity_f64
        self.engine = engine           # the routing line's engine name

    def __iter__(self):  # allow `uks, Uf = Grape(...)` tuple unpacking
        return iter((self.uks, self.Uf))


LBFGS_NAMES = ("L-BFGS-JAX", "LBFGS", "LBFGS-JAX")
SCIPY_NAMES = ("BFGS", "L-BFGS-B")


def Grape(
    H0,
    Hops,
    Hnames,
    U,
    total_time,
    steps,
    states_concerned_list,
    convergence: Optional[dict] = None,
    U0=None,
    reg_coeffs: Optional[dict] = None,
    dressed_info: Optional[dict] = None,
    maxA=None,
    use_gpu: bool = True,            # accepted for compat; see ``device``
    sparse_H: bool = True,           # accepted for compat; ignored
    sparse_U: bool = False,
    sparse_K: bool = False,
    draw=None,
    initial_guess=None,
    show_plots: bool = True,
    unitary_error: float = 1e-4,
    method: str = "Adam",
    state_transfer: bool = False,
    no_scaling: bool = False,
    freq_unit: str = "GHz",
    file_name: Optional[str] = None,
    save: bool = True,
    data_path: Optional[str] = None,
    Taylor_terms=None,
    use_inter_vecs: bool = True,
    gradient_mode: str = "exact",
    engine: str = "auto",
    seed: Optional[int] = None,
    remat: bool = False,
    resume_from: Optional[str] = None,
    device=None,
) -> GrapeResult:
    grape_start_time = time.time()
    with span("qoc.grape.front_end"):
        time_unit = {"GHz": "ns", "MHz": "us", "KHz": "ms",
                     "Hz": "s"}[freq_unit]
        method_u = method.upper()
        if method_u not in ("ADAM", "EVOLVE") + LBFGS_NAMES + SCIPY_NAMES:
            raise ValueError(f"unknown method {method!r}")
        device = entry_device(device)

        file_path = None
        if save:
            from .utils.h5 import next_run_path, require_h5py

            require_h5py()
            if file_name is None:
                raise ValueError(
                    "Grape function input: file_name, is not specified.")
            if data_path is None:
                raise ValueError(
                    "Grape function input: data_path, is not specified.")
            file_path = next_run_path(data_path, file_name)
            print("data saved at: " + str(file_path))

        conv = ConvergenceSettings.from_dict(convergence)

        if save:
            from .utils.h5 import save_run_inputs

            save_run_inputs(
                file_path,
                H0=H0, Hops=Hops, Hnames=Hnames, U=U,
                total_time=total_time, steps=steps,
                states_concerned_list=states_concerned_list,
                maxA=maxA, initial_guess=initial_guess, method=method,
                convergence=convergence
                or {"rate": conv.rate, "update_step": conv.update_step,
                    "max_iterations": conv.max_iterations,
                    "conv_target": conv.conv_target,
                    "learning_rate_decay": conv.learning_rate_decay},
                reg_coeffs=reg_coeffs, dressed_info=dressed_info,
                use_gpu=use_gpu, sparse_H=sparse_H, sparse_U=sparse_U,
                sparse_K=sparse_K,
            )

        problem = ControlProblem.build(
            H0, Hops, Hnames, U, total_time, steps, states_concerned_list,
            U0=U0, dressed_info=dressed_info, maxA=maxA,
            initial_guess=initial_guess, unitary_error=unitary_error,
            state_transfer=state_transfer, no_scaling=no_scaling,
            Taylor_terms=Taylor_terms, use_inter_vecs=use_inter_vecs,
            seed=seed,
        )
        validate_reg_coeffs(reg_coeffs, state_num=problem.state_num)
        print(
            "Using %d Taylor terms and %d Scaling & Squaring terms"
            % (problem.taylor_terms, problem.taylor_scaling)
        )
        if save:
            from .utils.h5 import H5File

            with H5File(file_path, "a") as hf:
                hf.add("taylor_terms", problem.taylor_terms)
                hf.add("taylor_scaling", problem.taylor_scaling)
                hf.add("initial_vectors_c", problem.initial_vectors_c)

        # analysis forward (emits inter_vecs) vs lean optimization loss
        fwd_engine = "auto" if engine == "mega" else engine
        forward, _ = make_forward(problem, reg_coeffs=reg_coeffs,
                                  gradient_mode=gradient_mode,
                                  engine=fwd_engine, lean=False, device=device,
                                  remat=remat)
        _, loss_fn = make_forward(problem, reg_coeffs=reg_coeffs,
                                  gradient_mode=gradient_mode,
                                  engine=fwd_engine, lean=True, device=device,
                                  remat=remat)

        start_time = time.time()
        nfev = None
        iterative = method_u not in ("EVOLVE",) + SCIPY_NAMES
        if iterative:
            # Adam or the native L-BFGS, in segments up to the update_step grid
            adam = method_u == "ADAM"
            on_cuda = device.type == "cuda"
            use_mega = (
                adam and engine in ("auto", "mega")
                and mega_supported(problem, reg_coeffs, gradient_mode)
                and (engine == "mega" or on_cuda)
            )
            if use_mega:
                names = cost_names(reg_coeffs)
                resolved = "mega ({}{})".format(
                    "fused Adam segment CUDA kernel" if on_cuda
                    else "plain torch segment reference on cpu",
                    ", penalties: " + ", ".join(names) if names else "")
                announce("engine", resolved)
                init_mega, run_mega, unpad = make_mega_segment_runner(
                    problem, conv, reg_coeffs=reg_coeffs, device=device)
                state = init_mega(problem.u0_base)

                def advance(s, stop_at):
                    return run_mega(s, stop_at - s.iteration)
            else:
                resolved = loss_fn.resolved_engine
                announce("engine", resolved, reasons=(
                    fused_fallback_reasons(problem, reg_coeffs, gradient_mode,
                                           on_accel=on_cuda)
                    if adam and engine == "auto" else None))
                u0 = torch.as_tensor(problem.u0_base, device=device)
                if adam:
                    advance = make_segment_runner(loss_fn, conv)
                    state = init_adam_state(u0, conv)
                else:
                    init_lbfgs, advance = make_lbfgs_runner(loss_fn, conv)
                    state = init_lbfgs(u0)

                def unpad(u):
                    return u.detach().cpu().numpy()

            def host_u(s):
                return unpad(s.u_base)

            def checkpoint_now(s):
                save_checkpoint(file_path, checkpoint_leaves(s, problem.steps),
                                s.iteration)

            if resume_from is not None and adam:
                leaves, it_r = load_checkpoint(resume_from)
                state = state_from_leaves(leaves, it_r, problem.steps,
                                          state.u_base.shape[1], device)
                print(f"resumed from {resume_from} at iteration {it_r}")

    def analyse(u_base):
        with torch.no_grad():
            return forward(torch.as_tensor(
                np.asarray(u_base, dtype=np.float32), device=device))

    history = History()
    evol_state = {"last_idx": 0}

    def maybe_save_evolution(iteration, u_base):
        """Evolution snapshots every evol_save_step iterations
        (run_session.py:84-91)."""
        es = conv.evol_save_step
        if not save or es <= 0 or iteration <= 0:
            return
        idx = iteration // es
        if idx <= evol_state["last_idx"]:
            return
        evol_state["last_idx"] = idx
        out = analyse(u_base)
        _analysis.append_evolution(
            file_path, problem, out.final_state.cpu().numpy(),
            None if out.inter_vecs is None else out.inter_vecs.cpu().numpy())

    def evol_boundary_step(iteration, loss, reg_loss, uscale, u_base,
                           start_time):
        """Evol-grid-only boundary: a metrics row, then the snapshot."""
        es = conv.evol_save_step
        if (save and es > 0 and iteration > 0 and iteration % es == 0
                and iteration // es > evol_state["last_idx"]):
            _analysis.append_metrics(
                file_path, error=loss, reg_error=reg_loss,
                uks=_analysis.uks_from_base(problem, u_base),
                iteration=iteration, run_time=time.time() - start_time,
                unitary_scale=uscale,
            )
        maybe_save_evolution(iteration, u_base)

    def display_dashboard(u_base) -> bool:
        """Redraw the dashboard (convergence.py:121-222) inside IPython;
        False, having drawn nothing, anywhere else."""
        try:
            import matplotlib.pyplot as plt
            from IPython import display as ipy_display
            from IPython import get_ipython
        except ImportError:
            return False
        if get_ipython() is None:
            return False
        from .utils import plotting as _plotting

        out = analyse(u_base)
        fig = _plotting.plot_summary(
            problem, history,
            uks=_analysis.uks_from_base(problem, u_base),
            final_state_c=(
                None if problem.state_transfer
                else _analysis.final_state_to_complex(
                    problem, out.final_state.cpu().numpy())),
            inter_vecs=(None if out.inter_vecs is None
                        else out.inter_vecs.cpu().numpy()),
            reg_coeffs=reg_coeffs, time_unit=time_unit, draw=draw,
        )
        ipy_display.display(fig)
        ipy_display.clear_output(wait=True)
        plt.close(fig)
        return True

    def save_step(iteration, loss, reg_loss, g2, uscale, u_base, start_time,
                  lr=None):
        history.record(iteration, loss, reg_loss, g2, uscale, lr=lr)
        if save:
            _analysis.append_metrics(
                file_path,
                error=loss, reg_error=reg_loss,
                uks=_analysis.uks_from_base(problem, u_base),
                iteration=iteration,
                run_time=time.time() - start_time,
                unitary_scale=uscale,
            )
        maybe_save_evolution(iteration, u_base)
        if not (show_plots and display_dashboard(u_base)):
            print(
                "Error = :%1.2e; Runtime: %.1fs; Iterations = %d, "
                "grads =  %10.3e, unitary_metric = %.5f"
                % (loss, time.time() - start_time, iteration, g2, uscale)
            )

    def next_stop(it: int) -> int:
        """Next segment boundary: the update_step grid and, when saving,
        the evol_save_step grid."""
        nxt = (it // conv.update_step + 1) * conv.update_step
        es = conv.evol_save_step
        if save and es > 0:
            nxt = min(nxt, (it // es + 1) * es)
        return min(nxt, conv.max_iterations + 1)

    if method_u == "EVOLVE":
        resolved = forward.resolved_engine
        announce("engine", resolved)
        u_base = np.asarray(problem.u0_base)
        out = analyse(u_base)
        loss, reg_loss, uscale = (
            float(out.loss), float(out.reg_loss), float(out.unitary_scale))
        iterations = 0
        save_step(0, loss, reg_loss, 0.0, uscale, u_base, start_time)
    elif method_u in SCIPY_NAMES:
        resolved = loss_fn.resolved_engine
        announce("engine", resolved)
        print("Starting " + method_u + " Optimization")

        def cb(iteration, loss, reg_loss, g2, uscale, u_base):
            if iteration % conv.update_step == 0:
                save_step(iteration, loss, reg_loss, g2, uscale, u_base,
                          start_time)

        u_base, res = run_scipy_optimizer(
            loss_fn, problem.u0_base, conv, method=method_u, callback=cb,
            device=device)
        print(method_u + " optimization done")
        out = analyse(u_base)
        loss, reg_loss = float(out.loss), float(out.reg_loss)
        uscale = float(out.unitary_scale)
        # ``nit`` counts optimizer iterations; the reference's per-eval
        # counter (run_session.py:151-167) counted linesearch probes too,
        # which stay available as nfev
        iterations = int(res.get("nit", res.get("nfev", 0)))
        nfev = int(res.get("nfev", 0))
        if not show_plots:
            print(res.message)
            print("Error = %1.2e" % loss)
            print("Total time is " + str(time.time() - start_time))
    else:
        # the loop's span holds the host's moments between a segment's span
        # and its boundary's, so that a profile charges them to the program
        with span("qoc.grape.loop"):
            try:
                while True:
                    with span("qoc.grape.segment"):
                        state = advance(state, next_stop(state.iteration))
                    with span("qoc.grape.boundary"):
                        it_now = state.iteration
                        if it_now % conv.update_step == 0 or state.done:
                            save_step(it_now, state.loss, state.reg_loss,
                                      state.grad_squared, state.unitary_scale,
                                      host_u(state), start_time,
                                      lr=(conv.learning_rate(it_now) if adam
                                          else None))
                            if save and adam:
                                checkpoint_now(state)
                        else:
                            evol_boundary_step(it_now, state.loss,
                                               state.reg_loss,
                                               state.unitary_scale,
                                               host_u(state), start_time)
                    if state.done:
                        break
            except KeyboardInterrupt:
                # graceful interrupt of an Adam run (grape.py:130-139): persist
                # the wall clock and the latest checkpoint, return the current
                # iterate; the run resumes with resume_from=<file>
                if not adam:
                    raise
                if save:
                    from .utils.h5 import H5File

                    checkpoint_now(state)
                    with H5File(file_path, "a") as hf:
                        hf.add("wall_clock_time",
                               np.array(time.time() - grape_start_time))
                    print("interrupted; data saved at: " + str(file_path))

    with span("qoc.grape.readout"):
        if iterative:
            u_base = host_u(state)
            loss, reg_loss = state.loss, state.reg_loss
            uscale = state.unitary_scale
            iterations = state.iteration
            nfev = None if adam else state.evaluations
            out = analyse(u_base)

        final_state = out.final_state.cpu().numpy()
        inter_vecs = (None if out.inter_vecs is None
                      else out.inter_vecs.cpu().numpy())
        uks = _analysis.uks_from_base(problem, u_base)
        with span("qoc.grape.fidelity_f64"):
            # on the card the readout runs there as batched complex128
            # matrices; on the CPU, the host loop
            fid64 = _analysis.fidelity_f64(
                problem, uks,
                device=device if device.type == "cuda" else None)
        if save:
            _analysis.append_metrics(
                file_path, error=loss, reg_error=reg_loss, uks=uks,
                iteration=iterations, run_time=time.time() - start_time,
                unitary_scale=uscale,
            )
            _analysis.append_evolution(file_path, problem, final_state,
                                       inter_vecs)

        if problem.state_transfer:
            Uf = []
        else:
            Uf = _analysis.final_state_to_complex(problem, final_state)

        if save:
            from .utils.h5 import H5File

            with H5File(file_path, "a") as hf:
                hf.add("wall_clock_time",
                       np.array(time.time() - grape_start_time))
                hf.add("fidelity_f64", np.array(fid64))
            print("data saved at: " + str(file_path))

        return GrapeResult(
            uks=uks, Uf=Uf, u_base=u_base, loss=loss, reg_loss=reg_loss,
            unitary_scale=uscale, iterations=iterations, history=history,
            file_path=file_path, inter_vecs=inter_vecs, problem=problem,
            nfev=nfev, fidelity_f64=fid64, engine=resolved,
        )
