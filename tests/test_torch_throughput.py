"""The fixed-count Adam runner (``optim.adam.make_throughput_runner``,
the counterpart of qoc_tpu's) on the CPU: against qoc_tpu's
``make_throughput_runner`` with ``make_adam_optimizer`` from the same
numpy pulse, all ``n`` iterations below conv_target, the bits of
``make_segment_runner`` with convergence off, and no read back from the
tensors inside ``run_n``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
from qoc_tpu.models.forward import make_forward as q_make_forward
from qoc_tpu.models.system import ControlProblem as QProblem
from qoc_tpu.optim.adam import make_adam_optimizer
from qoc_tpu.optim.adam import make_throughput_runner as q_runner
from qoc_tpu.optim.convergence import ConvergenceSettings as QConv
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.optim import adam
from qoc_tpu_torch.optim.adam import (init_adam_state, make_segment_runner,
                                      make_throughput_runner)
from qoc_tpu_torch.optim.convergence import ConvergenceSettings

torch.set_num_threads(1)

CONV = {"rate": 0.01, "update_step": 100, "max_iterations": 5000,
        "conv_target": 1e-4}
LEAKAGE_RC = {"forbidden_coeff_list": [10.0, 10.0, 10.0],
              "states_forbidden_list": [2, 3, 4], "dwdt": 0.001}


def _pi_pulse():
    """bench.py's pi pulse at T = 40."""
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 40,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[0.7, 0.7], seed=0), None)


def _leakage():
    """bench.py's transmon-leakage problem (T = 100) with its costs."""
    a = q.annihilate(5)
    H0 = 2 * np.pi * (-0.2) / 2 * (a.conj().T @ a.conj().T @ a @ a)
    return ((H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             q.transmon_gate(q.SIGMA_X, 5), 6.0, 100, [0, 1]),
            dict(maxA=[2.0, 2.0], seed=0), LEAKAGE_RC)


def _port_runner(make, conv=CONV, runner=make_throughput_runner):
    args, kwargs, rc = make()
    p = ControlProblem.build(*args, **kwargs)
    conv = ConvergenceSettings.from_dict(conv)
    _, loss_fn = make_forward(p, rc, engine="scan", lean=True, device="cpu")
    s0 = init_adam_state(torch.as_tensor(np.asarray(p.u0_base, np.float32)),
                         conv)
    return runner(loss_fn, conv), s0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@functools.lru_cache(maxsize=None)
def _qoc_tpu_run(make, n):
    """(u_base, mu, nu, lr, count) of qoc_tpu's fixed-count runner with
    ``make_adam_optimizer`` after ``n`` iterations on the scan engine."""
    args, kwargs, rc = make()
    qp = QProblem.build(*args, **kwargs)
    qconv = QConv.from_dict(CONV)
    _, q_loss = q_make_forward(qp, rc, engine="scan", lean=True)
    opt = make_adam_optimizer(qconv)
    u0 = jnp.asarray(qp.u0_base)
    u_q, (adam_q, lr_q, _) = q_runner(q_loss, qconv, opt)(u0, opt.init(u0),
                                                          n)
    return (np.asarray(u_q), np.asarray(adam_q.mu), np.asarray(adam_q.nu),
            np.float32(lr_q["lr"]), int(adam_q.count), np.asarray(u0))


def _gaps(make, n=5):
    """The port's runner against qoc_tpu's after ``n`` iterations from
    the same numpy u0: (state, relative gaps of u_base, m and v)."""
    u_q, mu_q, nu_q, _, _, u0 = _qoc_tpu_run(make, n)
    run_n, s0 = _port_runner(make)
    np.testing.assert_array_equal(s0.u_base.numpy(), u0)
    s = run_n(s0, n)
    return s, {"u_base": _rel(s.u_base, u_q), "m": _rel(s.m, mu_q),
               "v": _rel(s.v, nu_q)}


def _adam_step_f32_bias(s, g, factor):
    """``optim.adam._adam_step`` with optax's bias corrections: 1 - beta^t
    formed in float32 (the port forms it in float64)."""
    count = s.iteration + 1
    m = adam.B1 * s.m + (1.0 - adam.B1) * g
    v = adam.B2 * s.v + (1.0 - adam.B2) * (g * g)
    c1 = float(np.float32(1) - np.float32(adam.B1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(adam.B2) ** np.float32(count))
    u_new = s.u_base - s.lr * ((m / c1) / (torch.sqrt(v / c2) + adam.EPS))
    return dict(u_base=u_new.detach(), m=m, v=v,
                lr=float(np.float32(s.lr) * factor), iteration=count)


# after 5 iterations, relative to the largest entry: about 2.5x what this
# CPU measures (pi pulse u_base 1.07e-6, m 1.50e-6, v 1.84e-6; leakage
# 1.52e-6, 4.43e-6, 8.70e-6) ...
BARS = {"pi_pulse_t40": {"u_base": 3e-6, "m": 4e-6, "v": 5e-6},
        "leakage": {"u_base": 4e-6, "m": 1e-5, "v": 2e-5}}
# ... and with float32 bias corrections in the port's step (measured pi
# pulse 7.2e-8, 1.3e-7, 2.4e-7; leakage 1.3e-7, 2.3e-7, 3.0e-7)
BARS_F32_BIAS = {"pi_pulse_t40": {"u_base": 2e-7, "m": 4e-7, "v": 6e-7},
                 "leakage": {"u_base": 4e-7, "m": 6e-7, "v": 8e-7}}
CASES = {"pi_pulse_t40": _pi_pulse, "leakage": _leakage}


@pytest.mark.parametrize("case", list(CASES))
def test_throughput_runner_matches_qoc_tpu(case):
    """5 iterations on the scan engine from the same numpy u0: u_base, m
    and v within ``BARS`` of qoc_tpu's optax chain, relative to the largest
    entry, and the learning rate and count carried alike.  The iteration-0
    gradients are 1.4e-7 / 9.0e-7 apart (pi pulse / leakage); most of the
    rest is the bias correction (``test_bias_correction_is_the_gap``)."""
    s, gaps = _gaps(CASES[case])
    _, _, _, lr_q, count_q, _ = _qoc_tpu_run(CASES[case], 5)
    assert s.iteration == 5 and count_q == 5
    for field, bar in BARS[case].items():
        assert gaps[field] <= bar, (field, gaps[field])
    assert np.float32(s.lr) == lr_q


@pytest.mark.parametrize("case", list(CASES))
def test_bias_correction_is_the_gap(case, monkeypatch):
    """The port's Adam (whose bits the segment runner and resume keep)
    forms 1 - beta^t in float64, optax in float32, where 1 - float32(0.999)
    is 1.3e-5 below 1e-3.  With the port's step forming them in float32,
    every gap to qoc_tpu falls at least 4x, to ``BARS_F32_BIAS``: what
    is left comes from the gradients."""
    _, gaps = _gaps(CASES[case])
    monkeypatch.setattr(adam, "_adam_step", _adam_step_f32_bias)
    _, gaps32 = _gaps(CASES[case])
    for field, bar in BARS_F32_BIAS[case].items():
        assert gaps32[field] <= bar, (field, gaps32[field])
        assert 4 * gaps32[field] <= gaps[field], (field, gaps32, gaps)


def test_runs_every_iteration_below_conv_target():
    """conv_target 1 (every loss is below it): the segment runner stops at
    its first metrics; the throughput runner takes all n steps."""
    conv = dict(CONV, conv_target=1.0)
    run_n, s0 = _port_runner(_pi_pulse, conv)
    seg, _ = _port_runner(_pi_pulse, conv, make_segment_runner)
    stopped = seg(s0, 7)
    assert stopped.done and stopped.iteration == 0
    assert torch.equal(stopped.u_base, s0.u_base)
    s = run_n(s0, 7)
    assert s.iteration == 7 and not s.done
    assert not torch.equal(s.u_base, s0.u_base)


@pytest.mark.parametrize("make", [_pi_pulse, _leakage],
                         ids=["pi_pulse_t40", "leakage"])
def test_same_bits_as_segment_runner(make):
    """Convergence off (conv_target and min_grad -1): the same u_base, m,
    v, learning rate and iteration count as ``make_segment_runner``."""
    conv = dict(CONV, conv_target=-1.0, min_grad=-1.0)
    run_n, s0 = _port_runner(make, conv)
    seg, _ = _port_runner(make, conv, make_segment_runner)
    a, b = run_n(s0, 6), seg(s0, 6)
    assert a.iteration == b.iteration == 6
    for x, y in ((a.u_base, b.u_base), (a.m, b.m), (a.v, b.v)):
        assert torch.equal(x, y)
    assert a.lr == b.lr


def test_reads_nothing_back(monkeypatch):
    """``run_n`` turns no tensor into a Python value (the reads that
    synchronise with a card): ``item``, ``tolist``, ``float``, ``int``
    and ``bool`` of a tensor raise while it runs."""
    run_n, s0 = _port_runner(_pi_pulse)

    def refuse(*_):
        raise AssertionError("run_n read a tensor back")

    for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    s = run_n(s0, 3)
    monkeypatch.undo()
    assert s.iteration == 3 and torch.isfinite(s.u_base).all()
