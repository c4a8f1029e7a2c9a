"""BASELINE config 4 (the transmon-cavity state transfer, the benchmark's
configuration ``transmon_cavity``) on the CPU.

The port's ``Grape`` Adam on the pscan engine, with all three of the
configuration's costs (dwdt, bandpass, speed_up) and its dressed basis,
against the benchmark's plain float64 reference
(``benchmark/reference/grape.py``) over three iterations, at a small
config-4-shaped size (a 2-level transmon times a 4-level cavity, M = 16,
T = 64); a planted fault, speed_up's trajectory cut out of the gradient,
fails the same comparison.  The configuration's arrays are the published
job's.  The pscan sweeps and the costs record their spans under a
profiler, inside the iteration's ``qoc.step.grad``, also under the batch
layer's ``vmap``, with the bits of a solve without one; and the
benchmark's readers ``sweep_ms`` and ``costs_ms`` read those spans."""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qoc_tpu_torch as qt
from benchmark import harness
from benchmark.reference import grape as ref
from benchmark.trace import Event
from qoc_tpu_torch.models import costs
from qoc_tpu_torch.parallel.batch import batched_grape_adam
from qoc_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIG = json.loads((harness.HERE / "configs"
                     / "transmon_cavity.json").read_text())
MAKER = harness.load_module(harness.HERE / "configs" / "transmon_cavity.py",
                            "config_transmon_cavity")
# the check call's settings: three iterations in one segment, the
# configuration's rate, nothing frozen before the iteration limit
CONV = {"rate": 0.02, "update_step": 3, "max_iterations": 3,
        "conv_target": 1e-8, "learning_rate_decay": 2500.0,
        "min_grad": 1e-25}
# float32 port against the float64 reference: the loss and the loss with
# the costs sum 64 steps of float32 products (a few ulps of 1 each) and
# read 1.5e-7 to 9.6e-7 over seeds 0-2: 5e-6 leaves five times that
LOSS_TOL = 5e-6
# the last gradient's norm, relative: 1.0e-6 to 2.0e-6 (the same
# rounding through the adjoint); the planted fault reads 2.1e-3 to 2.3e-3
GRAD_TOL = 2e-5
# the pulses' RMS gap over the rate (in first Adam steps): 4.3e-6 to
# 3.6e-5, where g / (|g| + eps) amplifies the rounding of small
# gradients; the planted fault reads 3.8e-3 to 3.4e-2
STEP_TOL = 2e-4


def _small_system():
    """Config 4's system with its costs, band, drives and dressed basis,
    cut to a 2-level transmon and a 4-level cavity (M = 16, which pscan
    admits) and 64 steps of 2 ns / 64, so that the band [0.1, 10] GHz
    leaves bins [20, 32) to the bandpass cost."""
    cfg = dict(CONFIG, transmon_levels=2, cavity_levels=4, steps=64,
               total_time=2.0)
    return MAKER.build(cfg)


def _guess(s, seed: int) -> np.ndarray:
    """Physical pulses [K, T] from a seeded draw in the base domain, large
    enough (3 / sqrt(T) a step) that the costs' gradients count."""
    K, T = len(s["Hops"]), s["steps"]
    u = np.random.default_rng(seed).standard_normal((K, T)) * 3 / np.sqrt(T)
    return np.asarray(s["maxA"])[:, None] * np.sin(u)


def _grape(s, guess):
    return qt.Grape(
        s["H0"], s["Hops"], s["Hnames"], s["target"], s["total_time"],
        s["steps"], s["states"], convergence=CONV,
        reg_coeffs=s["reg_coeffs"], maxA=s["maxA"], initial_guess=guess,
        method="Adam", state_transfer=True, save=False, show_plots=False,
        device="cpu", engine="pscan", **s["grape_kwargs"])


def _gaps(seed: int) -> dict:
    """The port's three iterations against the reference's, from the same
    pulses: |loss| and |reg_loss| gaps at the end, the last gradient's
    norm (relative) and the pulses' RMS gap over the rate."""
    s = _small_system()
    guess = _guess(s, seed)
    res = _grape(s, guess)
    assert res.engine == "pscan" and res.iterations == 3
    maxA = np.asarray(s["maxA"])[:, None]
    u0 = torch.as_tensor(np.arcsin(guess / maxA)[None])
    r = ref.adam_steps(ref.problem_from_system(s), u0, CONV, n_steps=3)
    g_ref = float(r["grad_last"].norm())
    g = float(np.sqrt(2.0 * res.history.grad_squareds[-1]))
    du = np.asarray(res.u_base, np.float64) - r["u"][0].numpy()
    return {"loss": abs(res.loss - float(r["losses"][0, -1])),
            "reg_loss": abs(res.reg_loss - float(r["reg_losses"][0, -1])),
            "grad": abs(g - g_ref) / g_ref,
            "step": float(np.sqrt(np.mean(du ** 2))) / CONV["rate"]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grape_on_pscan_with_the_costs_follows_the_reference(seed):
    gaps = _gaps(seed)
    assert gaps["loss"] < LOSS_TOL and gaps["reg_loss"] < LOSS_TOL, gaps
    assert gaps["grad"] < GRAD_TOL and gaps["step"] < STEP_TOL, gaps


def test_the_comparison_sees_speed_ups_trajectory_term(monkeypatch):
    """speed_up with its trajectory cut out of the gradient (the value
    kept): the co-states lose its term, and the gradient and the steps
    part from the reference's."""
    sound = costs.REGISTRY["speed_up"]

    def cut(ctx, reg_coeffs):
        ctx = SimpleNamespace(**vars(ctx))
        ctx.inter_vecs = ctx.inter_vecs.detach()
        return sound(ctx, reg_coeffs)

    monkeypatch.setitem(costs.REGISTRY, "speed_up", cut)
    gaps = _gaps(0)
    assert gaps["grad"] > 10 * GRAD_TOL and gaps["step"] > 10 * STEP_TOL, gaps


def test_the_configuration_is_the_published_job():
    """The system file's arrays against examples/jobs/transmon_cavity.npz
    and .json (written by examples/jobs/torch_make_transmon_cavity.py):
    the matrices bit for bit; each eigenvector, and the two states, up to
    the sign an eigensolver may choose; the dressed assignment, the
    amplitudes, the costs and the horizon as the job gives them."""
    s = MAKER.build(CONFIG)
    npz = np.load(REPO / "examples" / "jobs" / "transmon_cavity.npz")
    job = json.loads((REPO / "examples" / "jobs"
                      / "transmon_cavity.json").read_text())
    np.testing.assert_array_equal(s["H0"], npz["H0"])
    for k, h in enumerate(s["Hops"]):
        np.testing.assert_array_equal(h, npz[f"H{k + 1}"])
    info = s["grape_kwargs"]["dressed_info"]

    def same_up_to_sign(a, b):
        a, b = np.asarray(a), np.asarray(b)
        sign = np.sign(np.real(np.vdot(b, a)))
        np.testing.assert_allclose(a, sign * b, atol=1e-12)

    for j in range(60):
        same_up_to_sign(info["eigenvectors"][:, j], npz["eigenvectors"][:, j])
    np.testing.assert_allclose(info["eigenvalues"], npz["eigenvalues"],
                               atol=1e-12)
    assert info["dressed_id"] == job["dressed_info"]["dressed_id"]
    assert info["is_dressed"] is True
    same_up_to_sign(s["states"][0], npz["psi0"])
    same_up_to_sign(s["target"][0], npz["target"])
    assert s["maxA"] == job["maxA"] and s["reg_coeffs"] == job["reg_coeffs"]
    assert (s["total_time"], s["steps"]) == (job["total_time"], job["steps"])
    conv = job["convergence"]
    assert {k: CONFIG[k] for k in ("rate", "update_step", "conv_target")} == {
        k: conv[k] for k in ("rate", "update_step", "conv_target")}
    assert CONFIG["source_values"]["max_iterations"] == conv["max_iterations"]
    assert CONFIG["reduced"] == ["max_iterations"]


def _traced(fn):
    """fn() under a CPU profiler: (its result, the ``qoc.`` spans as
    (name, start, end, thread) sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.start_thread_id())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("qoc.")), key=lambda s: s[1])
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_pscan_solve_records_its_sweeps_and_costs_in_each_gradient():
    """Each of the four loss-and-gradients (iterations 0-3) holds one
    forward sweep, one reverse sweep (in the backward: on the CPU the
    calling thread runs it; on a card the autograd engine's device
    thread, to which the engine hands the profiler's state) and one
    costs span; the readout's analysis forward sweeps and costs once
    more.  The solve under the profiler gives the bits of one without."""
    s = _small_system()
    guess = _guess(s, 3)
    plain = _grape(s, guess)
    res, spans = _traced(lambda: _grape(s, guess))
    grads = _named(spans, "qoc.step.grad")
    assert len(grads) == 4
    for name in ("qoc.pscan.sweep", "qoc.pscan.reverse", "qoc.costs"):
        got = _named(spans, name)
        inner = [x for x in got if any(_inside(x, g) for g in grads)]
        assert [sum(_inside(x, g) for x in got) for g in grads] == [1] * 4, (
            name, got)
        readout = _named(spans, "qoc.grape.readout")[0]
        assert len(got) - len(inner) == (name != "qoc.pscan.reverse"), name
        assert all(_inside(x, readout) for x in got if x not in inner)
    assert (plain.loss, plain.reg_loss) == (res.loss, res.reg_loss)
    np.testing.assert_array_equal(plain.u_base, res.u_base)


def test_the_spans_are_the_null_context_with_no_session():
    assert not torch.autograd._profiler_enabled()
    for name in ("qoc.pscan.sweep", "qoc.pscan.reverse", "qoc.costs"):
        assert profiling.span(name) is profiling._NO_SPAN


def _batch(problem, reg):
    return batched_grape_adam(
        problem, n_seeds=2, reg_coeffs=reg, seed=5, backend="xla",
        engine="pscan", device="cpu",
        convergence={"rate": 0.02, "update_step": 2, "max_iterations": 2,
                     "conv_target": 1e-8})


def test_the_batch_layer_runs_pscan_under_vmap_with_a_session():
    """``batched_grape_adam(backend="xla", engine="pscan")`` vmaps each
    seed's loss and gradient through the pscan Function and the costs:
    with a session recording it runs, records the sweeps and the costs,
    and gives the bits of the run without one."""
    s = _small_system()
    problem = qt.ControlProblem.build(
        s["H0"], s["Hops"], s["Hnames"], s["target"], s["total_time"],
        s["steps"], s["states"], state_transfer=True, maxA=s["maxA"],
        seed=0, **s["grape_kwargs"])
    plain = _batch(problem, s["reg_coeffs"])
    out, spans = _traced(lambda: _batch(problem, s["reg_coeffs"]))
    assert out["iterations"] == plain["iterations"] == 3
    for key in ("losses", "reg_losses", "u_base"):
        np.testing.assert_array_equal(out[key], plain[key])
    grads = _named(spans, "qoc.step.grad")
    assert grads
    for name in ("qoc.pscan.sweep", "qoc.pscan.reverse", "qoc.costs"):
        assert any(_inside(x, g) for x in _named(spans, name)
                   for g in grads), name


MS = 1_000_000


def _read(metric, events, lo=0, hi=1000 * MS):
    ctx = SimpleNamespace(events=events, lo=lo, hi=hi)
    return harness.load_module(harness.metric_path(metric),
                               "m_" + metric.replace(".", "_")).read(ctx)


def _host(name, a, b):
    return Event(name, "host", int(a * MS), int(b * MS))


def test_sweep_and_costs_readers_on_synthetic_spans():
    """Two iterations: the sweeps' and the costs' ms summed over the
    window's ``qoc.step.grad`` count; spans across the window's edges
    are left out; without the spans (a parent, another engine) None."""
    ev = [_host("qoc.step.grad", 10, 20), _host("qoc.pscan.sweep", 11, 14),
          _host("qoc.costs", 14, 15), _host("qoc.pscan.reverse", 15, 19),
          _host("qoc.step.grad", 30, 40), _host("qoc.pscan.sweep", 31, 33),
          _host("qoc.costs", 33, 33.5), _host("qoc.pscan.reverse", 34, 39),
          _host("qoc.pscan.sweep", 50, 52), _host("qoc.costs", 52, 53),
          _host("qoc.pscan.sweep", -5, 5), _host("qoc.costs", 995, 1005),
          _host("qoc.step.grad", 990, 1010), Event("k", "device", 0, 10)]
    assert _read("sweep_ms.single", ev) == pytest.approx((3 + 4 + 2 + 5 + 2)
                                                         / 2)
    assert _read("costs_ms.single", ev) == pytest.approx((1 + 0.5 + 1) / 2)
    bare = [e for e in ev if not e.name.startswith("qoc.pscan")
            and e.name != "qoc.costs"]
    assert _read("sweep_ms.single", bare) is None
    assert _read("costs_ms.single", bare) is None
    no_grad = [e for e in ev if e.name != "qoc.step.grad"]
    assert _read("sweep_ms.single", no_grad) is None
    assert _read("costs_ms.single", no_grad) is None
