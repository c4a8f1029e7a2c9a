"""Live optimization dashboard (matplotlib), decoupled from the step loop.

A copy of ``qoc_tpu.utils.plotting`` on the port's front end; matplotlib
is imported when a figure is drawn.

Reimplements the reference's Convergence dashboard (core/convergence.py:
86-222): log-scale error curves, Re/Im heatmaps of the final unitary,
optimized pulse plots, and per-initial-state population evolution with a
forbidden-population overlay.  Unlike the reference, plotting consumes
fetched numpy snapshots — it never touches device state, so the jitted
optimization loop is unaffected by display cadence.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.system import ControlProblem
from . import analysis as _analysis


def _require_matplotlib():
    import matplotlib.pyplot as plt

    return plt


def plot_pulses(ax, problem: ControlProblem, uks: np.ndarray,
                time_unit: str = "ns"):
    """Optimized control amplitudes over time (convergence.py:181-193)."""
    ts = problem.dt * np.arange(problem.steps)
    names = problem.Hnames or [str(k) for k in range(problem.ops_len)]
    for k in range(problem.ops_len):
        ax.plot(ts, uks[k], label="u" + str(names[k]))
    ax.set_title("Optimized pulse")
    ax.set_ylabel("Amplitude")
    ax.set_xlabel(f"Time ({time_unit})")
    ax.legend(ncol=min(problem.ops_len, 7))


def plot_error_curves(ax, history):
    """Fidelity error + total penalties vs iteration, log scale
    (convergence.py:155-164)."""
    it = np.array(history.iterations)
    ax.plot(it, np.array(history.costs), "bx-", label="Fidelity Error")
    ax.plot(it, np.array(history.reg_costs), "go-", label="All Penalties")
    ax.set_ylabel("Error")
    ax.set_xlabel("Iteration")
    try:
        ax.set_yscale("log")
    except ValueError:
        ax.set_yscale("linear")
    ax.legend()


def plot_unitary(ax_re, ax_im, Uf: np.ndarray):
    """Re/Im heatmaps of the final unitary (convergence.py:168-178)."""
    im0 = ax_re.imshow(np.real(Uf), interpolation="none", vmin=-1, vmax=1)
    ax_re.set_title("operator: real")
    im1 = ax_im.imshow(np.imag(Uf), interpolation="none", vmin=-1, vmax=1)
    ax_im.set_title("operator: imaginary")
    return im0, im1


def plot_populations(ax, problem: ControlProblem, pops: np.ndarray,
                     start_level: int, reg_coeffs: Optional[dict] = None,
                     time_unit: str = "ns", draw=None):
    """Level occupations over time for one initial state, with forbidden-
    population overlay (convergence.py:86-119).

    pops: [N, T+1] populations for one initial vector.
    """
    ts = problem.dt * np.arange(problem.steps + 1)
    if draw:
        draw_list, draw_names = draw
        for idx, name in zip(draw_list, draw_names):
            ax.plot(ts, pops[idx], label=str(name))
    else:
        if start_level > 4:
            ax.plot(ts, pops[start_level],
                    label=f"Starting level {start_level}")
        for lvl in range(min(4, pops.shape[0])):
            ax.plot(ts, pops[lvl], label=f"level {lvl}")
    if reg_coeffs and "states_forbidden_list" in reg_coeffs:
        forbidden = np.zeros(problem.steps + 1)
        for forbid in reg_coeffs["states_forbidden_list"]:
            forbidden = forbidden + pops[forbid]
        ax.plot(ts, forbidden, label="forbidden", linestyle="--", linewidth=4)
    ax.set_ylabel("Population")
    ax.set_ylim(-0.1, 1.1)
    ax.set_xlabel(f"Time ({time_unit})")
    ax.legend(ncol=7)


def plot_summary(
    problem: ControlProblem,
    history,
    uks: np.ndarray,
    final_state_c: Optional[np.ndarray] = None,
    inter_vecs: Optional[np.ndarray] = None,
    reg_coeffs: Optional[dict] = None,
    time_unit: str = "ns",
    draw=None,
    show: bool = False,
    save_path: Optional[str] = None,
):
    """Full dashboard figure (convergence.py:121-222 layout).

    Returns the matplotlib Figure; optionally saves to ``save_path``.
    In IPython contexts callers can refresh in place with
    ``IPython.display.display`` / ``clear_output`` around this call.
    """
    plt = _require_matplotlib()
    import matplotlib.gridspec as gridspec

    concerned = problem.states_concerned_list or []
    n_pop = len(concerned) if inter_vecs is not None else 0
    rows = 2 + (0 if problem.state_transfer else 1) + n_pop
    fig = plt.figure(figsize=(15, 3 * rows))
    gs = gridspec.GridSpec(rows, 2, figure=fig)
    index = 0

    ax = fig.add_subplot(gs[index, :])
    if history.iterations:
        plot_error_curves(ax, history)
        ax.set_title(
            "Error = %1.2e; Other errors = %1.2e; Unitary Metric: %.5f"
            % (
                history.costs[-1],
                history.reg_costs[-1] - history.costs[-1],
                history.unitary_scales[-1],
            )
        )
    index += 1

    if not problem.state_transfer and final_state_c is not None:
        ax_re = fig.add_subplot(gs[index, 0])
        ax_im = fig.add_subplot(gs[index, 1])
        plot_unitary(ax_re, ax_im, final_state_c)
        index += 1

    ax = fig.add_subplot(gs[index, :])
    plot_pulses(ax, problem, uks, time_unit)
    index += 1

    if inter_vecs is not None:
        pops = _analysis.populations(problem, inter_vecs)  # [V, N, T+1]
        for vi in range(n_pop):
            ax = fig.add_subplot(gs[index + vi, :])
            start = concerned[vi] if isinstance(concerned[vi], int) else 0
            plot_populations(ax, problem, pops[vi], start, reg_coeffs,
                             time_unit, draw)

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
    if show:  # pragma: no cover - interactive only
        plt.show()
    return fig
