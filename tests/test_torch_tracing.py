"""The port's spans on the CPU: ``utils.profiling.span`` is a shared null
context with no profiler and a host range under one; ``Grape`` and
``batched_grape_adam`` record their front end, segments, boundaries and
readout (and the per-iteration runners their steps) in the order and
nesting the benchmark's readers rely on; the plain versions of the fused
kernels record no launch span; the batched float64 readout records its
span once a call; and a solve under the profiler gives the bits of one
without it."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import qoc_tpu_torch as qt
from qoc_tpu_torch.parallel.batch import batched_grape_adam
from qoc_tpu_torch.utils.analysis import fidelity_f64, uks_from_base
from qoc_tpu_torch.utils.profiling import span, spanned

torch.set_num_threads(1)

# two segments: iterations 0-2, then 3-4 and the converged read at 5
CONV = {"rate": 0.01, "update_step": 3, "max_iterations": 5,
        "conv_target": 1e-12}


def _pi_args():
    return ((np.zeros((2, 2), dtype=complex), [qt.SIGMA_X, qt.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 32,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[2 * np.pi * 0.1] * 2, seed=0))


def _grape(engine):
    args, kwargs = _pi_args()
    return qt.Grape(*args, convergence=CONV, save=False, show_plots=False,
                    engine=engine, device="cpu", **kwargs)


def _batch(backend, progress=None):
    args, kwargs = _pi_args()
    problem = qt.ControlProblem.build(*args, **kwargs)
    return batched_grape_adam(problem, n_seeds=3, convergence=CONV, seed=4,
                              backend=backend, progress=progress,
                              device="cpu")


def _traced(fn):
    """fn() under a CPU profiler: (its result, the ``qoc.`` spans as
    (name, start, end) sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("qoc.")), key=lambda s: s[1])
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = span("qoc.test.a"), span("qoc.test.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass


def test_span_records_a_host_range_under_a_profiler():
    def body():
        with span("qoc.test.outer"):
            with span("qoc.test.inner"):
                return torch.ones(3).sum()

    _, spans = _traced(body)
    assert [s[0] for s in spans] == ["qoc.test.outer", "qoc.test.inner"]
    assert _inside(spans[1], spans[0]) and spans[0][2] > spans[0][1]


def test_spanned_records_each_call_and_keeps_the_function():
    @spanned("qoc.test.fn")
    def fn(x, y=1):
        """doc"""
        return x + y

    assert (fn.__name__, fn.__doc__, fn(1, y=2)) == ("fn", "doc", 3)
    out, spans = _traced(lambda: [fn(1), fn(2)])
    assert out == [2, 3]
    assert [s[0] for s in spans] == ["qoc.test.fn"] * 2


def test_build_warns_at_its_caller_through_its_span():
    args, kwargs = _pi_args()
    with pytest.warns(UserWarning, match="not Hermitian") as rec:
        qt.ControlProblem.build(np.array([[0, 1], [0, 0]], dtype=complex),
                                *args[1:], **kwargs)
    assert rec[0].filename == __file__


def _segments_and_boundaries(spans, kind, n):
    """The entry's segment and boundary spans alternate, ``n`` of each,
    inside its loop span, between its front end and its readout; returns
    the segments."""
    front = _named(spans, f"qoc.{kind}.front_end")
    readout = _named(spans, f"qoc.{kind}.readout")
    assert len(front) == 1 and len(readout) == 1
    outer = _named(spans, f"qoc.{kind}.loop")
    assert len(outer) == 1
    loop = [s for s in spans
            if s[0] in (f"qoc.{kind}.segment", f"qoc.{kind}.boundary")]
    assert [s[0].rsplit(".", 1)[1] for s in loop] == (
        ["segment", "boundary"] * n)
    for a, b in zip([front[0]] + loop, loop + [readout[0]]):
        assert a[2] <= b[1], (a, b)
    assert all(_inside(s, outer[0]) for s in loop)
    assert front[0][2] <= outer[0][1] and outer[0][2] <= readout[0][1]
    return loop[::2]


@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_grape_records_its_spans_in_order(engine):
    res, spans = _traced(lambda: _grape(engine))
    assert res.iterations == 5
    front = _named(spans, "qoc.grape.front_end")[0]
    build = _named(spans, "qoc.problem.build")
    assert len(build) == 1 and _inside(build[0], front)
    segments = _segments_and_boundaries(spans, "grape", 2)
    readout = _named(spans, "qoc.grape.readout")[0]
    assert max(s[2] for s in spans) == readout[2]
    fid = _named(spans, "qoc.grape.fidelity_f64")
    assert len(fid) == 1 and _inside(fid[0], readout)
    steps = {w: _named(spans, f"qoc.step.{w}")
             for w in ("grad", "read", "update")}
    if engine == "scan":
        # one grad and one read an iteration, the converged one (5)
        # included; an update for each of the 5 applied steps
        assert [len(steps[w]) for w in ("grad", "read", "update")] == [
            6, 6, 5]
        for s in steps["grad"] + steps["read"] + steps["update"]:
            assert any(_inside(s, seg) for seg in segments), s
        for g, r in zip(steps["grad"], steps["read"]):
            assert g[2] <= r[1]
    else:
        # the segment's plain version: no per-iteration runner, and no
        # launch path
        assert not any(steps.values())
    assert not _named(spans, "qoc.mega.prepare")


def _fidelity_readout(device):
    args, kwargs = _pi_args()
    problem = qt.ControlProblem.build(*args, **kwargs)
    return fidelity_f64(problem, uks_from_base(problem, problem.u0_base),
                        device=device)


@pytest.mark.parametrize("call,n", [
    (lambda: _fidelity_readout("cpu"), 1),
    (lambda: _fidelity_readout(None), 0),
    (lambda: _grape("scan"), 0)],
    ids=["batched", "host_loop", "grape_cpu"])
def test_the_batched_fidelity_readout_records_one_span(call, n):
    """The batched float64 readout records its span once a call; the host
    loop, which ``Grape`` keeps off the card, records none."""
    _, spans = _traced(call)
    assert len(_named(spans, "qoc.analysis.fidelity_f64_card")) == n


@pytest.mark.parametrize("backend", ["xla", "mega"])
def test_batched_grape_adam_records_its_spans_in_order(backend):
    out, spans = _traced(lambda: _batch(backend))
    assert out["iterations"] == 6
    front = _named(spans, "qoc.batch.front_end")[0]
    # the caller builds the problem, before the entry
    build = _named(spans, "qoc.problem.build")
    assert len(build) == 1 and build[0][2] <= front[1]
    segments = _segments_and_boundaries(spans, "batch", 2)
    assert segments[0][1] >= front[2]
    grads = _named(spans, "qoc.step.grad")
    if backend == "xla":
        # six iterations, the last a masked step of seeds frozen at the
        # iteration limit, each after its all(done) read
        assert [len(_named(spans, f"qoc.step.{w}"))
                for w in ("read", "grad", "update")] == [6, 6, 6]
        for s in grads:
            assert any(_inside(s, seg) for seg in segments), s
    else:
        assert not grads
    assert not _named(spans, "qoc.mega_batch.prepare")


def test_a_progress_hook_that_raises_leaves_a_closed_boundary_span():
    class Stop(Exception):
        pass

    def progress(it, losses, done):
        raise Stop

    def body():
        with pytest.raises(Stop):
            _batch("xla", progress)

    _, spans = _traced(body)
    segment = _named(spans, "qoc.batch.segment")
    boundary = _named(spans, "qoc.batch.boundary")
    loop = _named(spans, "qoc.batch.loop")
    assert len(segment) == 1 and len(boundary) == 1 and len(loop) == 1
    assert segment[0][2] <= boundary[0][1] < boundary[0][2] <= loop[0][2]
    assert max(s[2] for s in spans if s != loop[0]) == boundary[0][2]
    assert not _named(spans, "qoc.batch.readout")


@pytest.mark.parametrize("call", [
    lambda: _grape("scan"), lambda: _grape("mega"),
    lambda: _batch("xla"), lambda: _batch("mega")],
    ids=["grape_scan", "grape_mega", "batch_xla", "batch_mega"])
def test_a_solve_under_the_profiler_gives_the_same_bits(call):
    plain = call()
    traced, spans = _traced(call)
    assert spans
    if isinstance(plain, dict):
        assert plain["iterations"] == traced["iterations"]
        for key in ("losses", "reg_losses", "u_base", "converged"):
            np.testing.assert_array_equal(plain[key], traced[key])
    else:
        assert plain.iterations == traced.iterations
        assert (plain.loss, plain.reg_loss, plain.fidelity_f64) == (
            traced.loss, traced.reg_loss, traced.fidelity_f64)
        np.testing.assert_array_equal(plain.u_base, traced.u_base)
        np.testing.assert_array_equal(plain.uks, traced.uks)
