"""The port's copy of qoc_tpu's dashboard (``utils.plotting``) against the
original on the same problem, history, pulses and states (Agg backend:
the same titles, labels, legends, line and image data bit for bit), and
``Grape(show_plots=True)``'s dashboard: drawn once per update_step
boundary inside IPython, a progress line everywhere else."""

import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import qoc_tpu_torch as qt  # noqa: E402
from qoc_tpu.models.system import ControlProblem  # noqa: E402
from qoc_tpu.optim.convergence import History  # noqa: E402
from qoc_tpu.utils import plotting as qoc_plotting  # noqa: E402
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem  # noqa: E402
from qoc_tpu_torch.optim.convergence import History as TorchHistory  # noqa: E402
from qoc_tpu_torch.utils import plotting  # noqa: E402

torch.set_num_threads(1)


def _transmon(state_transfer: bool):
    """A 3-level transmon (T = 50): a gate on levels 0-1, or the 0 -> 1
    transfer; level 2 is forbidden."""
    a = qt.annihilate(3)
    H0 = np.diag([0.0, 1.0, 1.95]) * 2 * np.pi
    ops = [a + a.conj().T, 1j * (a - a.conj().T)]
    if state_transfer:
        psi0, tgt = np.eye(3, dtype=complex)[0], np.eye(3, dtype=complex)[1]
        return ((H0, ops, ["x", "y"], [tgt], 3.0, 50, [psi0]),
                dict(state_transfer=True, maxA=[0.5, 0.5], seed=0))
    return ((H0, ops, ["x", "y"], qt.transmon_gate(qt.SIGMA_X, 3), 3.0, 50,
             [0, 1]), dict(maxA=[0.5, 0.5], seed=0))


def _axes_content(fig):
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append(dict(
            title=ax.get_title(), xlabel=ax.get_xlabel(),
            ylabel=ax.get_ylabel(), yscale=ax.get_yscale(),
            lines=[(ln.get_label(), np.asarray(ln.get_xdata()),
                    np.asarray(ln.get_ydata())) for ln in ax.get_lines()],
            images=[np.asarray(im.get_array()) for im in ax.get_images()],
            legend=(None if legend is None
                    else [t.get_text() for t in legend.get_texts()])))
    return out


@pytest.mark.parametrize("state_transfer", [False, True],
                         ids=["gate", "state_transfer"])
def test_plot_summary_matches_qoc_tpu(state_transfer):
    args, kwargs = _transmon(state_transfer)
    problems = (TorchProblem.build(*args, **kwargs),
                ControlProblem.build(*args, **kwargs))
    rng = np.random.default_rng(7)
    p = problems[0]
    V = len(p.states_concerned_list)
    records = [(it, 10.0 ** -(1 + it / 10), 2 * 10.0 ** -(1 + it / 10),
                rng.random(), 1.0 - 1e-4 * rng.random()) for it in (0, 10, 20)]
    uks = rng.standard_normal((p.ops_len, p.steps))
    Uf = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    inter_vecs = rng.standard_normal((p.steps + 1, 2 * p.state_num, V))
    reg_coeffs = {"states_forbidden_list": [2], "forbidden_coeff_list": [1.0]}
    contents = []
    for problem, hist_cls, mod in zip(problems, (TorchHistory, History),
                                      (plotting, qoc_plotting)):
        history = hist_cls()
        for rec in records:
            history.record(*rec)
        fig = mod.plot_summary(problem, history, uks, final_state_c=Uf,
                               inter_vecs=inter_vecs, reg_coeffs=reg_coeffs)
        contents.append(_axes_content(fig))
        plt.close(fig)
    got, want = contents
    # errors, Re/Im of the final unitary (gates), pulses, V populations
    assert len(got) == len(want) == 2 + 2 * (not state_transfer) + V
    assert sum(len(g["images"]) for g in got) == 2 * (not state_transfer)
    for g, w in zip(got, want):
        for key in ("title", "xlabel", "ylabel", "yscale", "legend"):
            assert g[key] == w[key], key
        assert len(g["lines"]) == len(w["lines"]) > 0 or g["images"]
        for (gl, gx, gy), (wl, wx, wy) in zip(g["lines"], w["lines"]):
            assert gl == wl
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
        assert len(g["images"]) == len(w["images"])
        for gi, wi in zip(g["images"], w["images"]):
            np.testing.assert_array_equal(gi, wi)


CONV = {"rate": 0.01, "update_step": 10, "max_iterations": 30,
        "conv_target": 1e-8}


def _pi_grape(**kw):
    return qt.Grape(np.zeros((2, 2), dtype=complex), [qt.SIGMA_X, qt.SIGMA_Y],
                    ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 40,
                    [np.array([1, 0], dtype=complex)], state_transfer=True,
                    maxA=[0.7, 0.7], seed=0, convergence=CONV, save=False,
                    show_plots=True, device="cpu", **kw)


@pytest.mark.parametrize("where", ["ipython", "headless", "no_ipython"])
def test_grape_dashboard_inside_ipython_only(where, monkeypatch, capsys):
    """Inside IPython (a faked ``get_ipython``) every update_step boundary
    draws the dashboard and prints no progress line; headless, or with no
    IPython to import, each boundary prints its line and draws nothing."""
    import IPython
    from IPython import display

    shown, cleared = [], []
    monkeypatch.setattr(display, "display", lambda fig: shown.append(fig))
    monkeypatch.setattr(display, "clear_output",
                        lambda wait=False: cleared.append(wait))
    if where == "ipython":
        monkeypatch.setattr(IPython, "get_ipython", lambda: object())
    elif where == "no_ipython":
        monkeypatch.setitem(sys.modules, "IPython", None)
    res = _pi_grape()
    out = capsys.readouterr().out
    boundaries = len(res.history.iterations)
    assert boundaries == 4          # iterations 10, 20, 30 and 31
    progress = out.count("Error = :")
    if where == "ipython":
        assert len(shown) == boundaries and cleared == [True] * boundaries
        assert progress == 0
        # each figure is the dashboard of a state transfer: errors,
        # pulses and the one initial state's populations
        assert [ax.get_title() for ax in shown[-1].axes][1:] == [
            "Optimized pulse", ""]
    else:
        assert shown == [] and cleared == []
        assert progress == boundaries
