"""Checkpoint and resume in the port against qoc_tpu on the CPU: the leaf
layout of qoc_tpu's run files, runs saved by either package resumed by
the other, the segment route and the per-iteration route resuming each
other's checkpoints, qoc_tpu's own resume test on the port, and an
interrupted run leaving a resumable file."""

import h5py
import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu_torch as qt
from qoc_tpu_torch import grape as port_grape
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.ops.mega import make_mega_segment_runner
from qoc_tpu_torch.optim.adam import init_adam_state, make_segment_runner
from qoc_tpu_torch.optim.convergence import ConvergenceSettings
from qoc_tpu_torch.utils.checkpoint import (LEAVES, checkpoint_leaves,
                                            has_checkpoint, load_checkpoint,
                                            state_from_leaves)

torch.set_num_threads(1)

PI_ARGS = (np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
           ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 100,
           [np.array([1, 0], dtype=complex)])
PI_KW = dict(state_transfer=True, maxA=[0.7, 0.7], seed=0, method="Adam",
             show_plots=False)
SHORT = {"rate": 0.01, "update_step": 5, "max_iterations": 10,
         "conv_target": 1e-12}
LONG = {"rate": 0.01, "update_step": 50, "max_iterations": 1000,
        "conv_target": 1e-4}


def _qoc(tmp_path, name, conv, **kw):
    return q.Grape(*PI_ARGS, convergence=conv, save=True, file_name=name,
                   data_path=str(tmp_path), **PI_KW, **kw)


def _port(tmp_path, name, conv, **kw):
    return qt.Grape(*PI_ARGS, convergence=conv, save=True, file_name=name,
                    data_path=str(tmp_path), device="cpu", **PI_KW, **kw)


def _datasets(path):
    with h5py.File(path, "r") as hf:
        n = int(np.array(hf["ckpt_num_leaves"]))
        return (int(np.array(hf["ckpt_iteration"])),
                [np.array(hf["ckpt_leaf_%d" % i]) for i in range(n)])


@pytest.mark.parametrize("engine", ["scan", "mega"])
def test_leaf_layout_matches_qoc_tpu(tmp_path, engine):
    """Both packages write ckpt_iteration, ckpt_num_leaves = 5 and the
    leaves u, count, mu, nu, lr with the same shapes, dtypes and (to
    float32 rounding) values for the same 10 iterations."""
    want = _qoc(tmp_path, "q", SHORT, engine=engine)
    got = _port(tmp_path, "p", SHORT, engine=engine)
    it_w, leaves_w = _datasets(want.file_path)
    it_g, leaves_g = _datasets(got.file_path)
    assert it_w == it_g == 10
    assert len(leaves_g) == len(leaves_w) == len(LEAVES)
    for name, a, b in zip(LEAVES, leaves_w, leaves_g):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=name)
    assert int(leaves_g[1]) == 10
    assert has_checkpoint(got.file_path)


@pytest.mark.parametrize("writer,reader", [
    ("qoc_tpu", "port"), ("port", "qoc_tpu"), ("port", "port")])
def test_resume_continues_run(tmp_path, writer, reader):
    """tests/test_grape_e2e.py:157-182 with the port on either side: a run
    killed at 10 iterations continues from its checkpoint (iterations past
    the checkpoint's) and reaches the e2e bar."""
    run = {"qoc_tpu": _qoc, "port": _port}
    first = run[writer](tmp_path, "r1", SHORT)
    assert first.iterations == 10 and first.loss > 1e-4
    second = run[reader](tmp_path, "r2", LONG, resume_from=first.file_path)
    assert second.iterations > 10
    assert second.loss < 1e-4


def test_resume_matches_qoc_tpu_trajectory(tmp_path):
    """The same qoc_tpu checkpoint resumed by both packages for 20 more
    iterations on the per-iteration route gives the same pulse."""
    first = _qoc(tmp_path, "r1", SHORT, engine="scan")
    conv = dict(SHORT, max_iterations=30)
    want = _qoc(tmp_path, "w", conv, engine="scan",
                resume_from=first.file_path)
    got = _port(tmp_path, "g", conv, engine="scan",
                resume_from=first.file_path)
    assert got.iterations == want.iterations == 30
    np.testing.assert_allclose(got.uks, np.asarray(want.uks), atol=1e-4)
    np.testing.assert_allclose(got.loss, want.loss, atol=2e-5)


@pytest.mark.parametrize("first_engine,then_engine",
                         [("mega", "scan"), ("scan", "mega")])
def test_segment_and_per_iteration_routes_resume_each_other(
        tmp_path, first_engine, then_engine):
    """A checkpoint of the segment route resumes on the per-iteration
    route and the other way round, and lands where an uninterrupted run on
    the second route lands (u within 1e-4 after 20 iterations)."""
    first = _port(tmp_path, "a", SHORT, engine=first_engine)
    conv = dict(SHORT, max_iterations=30)
    resumed = _port(tmp_path, "b", conv, engine=then_engine,
                    resume_from=first.file_path)
    straight = _port(tmp_path, "c", conv, engine=first_engine)
    assert resumed.iterations == straight.iterations == 30
    np.testing.assert_allclose(resumed.uks, straight.uks, atol=1e-4)
    np.testing.assert_allclose(resumed.loss, straight.loss, atol=2e-5)


def _problem():
    return ControlProblem.build(*PI_ARGS, state_transfer=True,
                                maxA=[0.7, 0.7], seed=0)


@pytest.mark.parametrize("route", ["segment", "per_iteration"])
def test_leaves_round_trip_keeps_every_bit(route):
    """n iterations, checkpoint_leaves -> state_from_leaves, n iterations:
    u, m, v, lr and the iteration bit for bit those of 2n iterations run
    as two segments (the check chip_smoke.py's phase 9b makes on the
    card)."""
    p = _problem()
    conv = ConvergenceSettings.from_dict(dict(SHORT, max_iterations=100))
    n = 7
    if route == "segment":
        init, run, _ = make_mega_segment_runner(p, conv, device="cpu")
        state = init(p.u0_base)
        Tp = state.u_base.shape[1]

        def advance(s):
            return run(s, n)
    else:
        _, loss_fn = make_forward(p, lean=True, engine="scan", device="cpu")
        run = make_segment_runner(loss_fn, conv)
        state = init_adam_state(torch.as_tensor(p.u0_base), conv)
        Tp = p.steps

        def advance(s):
            return run(s, s.iteration + n)

    straight = advance(advance(state))
    half = advance(state)
    restored = state_from_leaves(checkpoint_leaves(half, p.steps),
                                 half.iteration, p.steps, Tp, "cpu")
    resumed = advance(restored)
    for field in ("u_base", "m", "v"):
        assert torch.equal(getattr(resumed, field), getattr(straight, field))
    assert resumed.lr == straight.lr
    assert resumed.iteration == straight.iteration == 2 * n


def test_state_from_leaves_rejects_a_mismatch():
    p = _problem()
    conv = ConvergenceSettings.from_dict(SHORT)
    leaves = checkpoint_leaves(
        init_adam_state(torch.as_tensor(p.u0_base), conv), p.steps)
    with pytest.raises(ValueError, match="leaves"):
        state_from_leaves(leaves[:4], 0, p.steps, p.steps)
    with pytest.raises(ValueError, match="shape"):
        state_from_leaves(leaves, 0, p.steps + 1, p.steps + 1)


def test_interrupt_leaves_a_resumable_file(tmp_path, monkeypatch):
    """A KeyboardInterrupt after the first segment saves the checkpoint and
    the wall clock and returns the iterate; the file then resumes."""
    real = port_grape.make_segment_runner

    def interrupting(loss_fn, conv):
        run = real(loss_fn, conv)
        calls = {"n": 0}

        def run_segment(state, stop_at):
            calls["n"] += 1
            if calls["n"] == 2:
                raise KeyboardInterrupt
            return run(state, stop_at)
        return run_segment

    monkeypatch.setattr(port_grape, "make_segment_runner", interrupting)
    res = _port(tmp_path, "int", dict(SHORT, max_iterations=100),
                engine="scan")
    assert res.iterations == 5
    leaves, it = load_checkpoint(res.file_path)
    assert it == 5 and len(leaves) == 5
    with h5py.File(res.file_path, "r") as hf:
        assert "wall_clock_time" in hf
    monkeypatch.setattr(port_grape, "make_segment_runner", real)
    again = _port(tmp_path, "again", LONG, engine="scan",
                  resume_from=res.file_path)
    assert again.iterations > 5 and again.loss < 1e-4


def test_resume_from_a_file_without_checkpoint_raises(tmp_path):
    res = qt.Grape(*PI_ARGS, convergence=SHORT, save=True,
                   file_name="evolve", data_path=str(tmp_path),
                   device="cpu", **dict(PI_KW, method="EVOLVE"))
    with pytest.raises(ValueError, match="no checkpoint"):
        _port(tmp_path, "r", LONG, resume_from=res.file_path)
