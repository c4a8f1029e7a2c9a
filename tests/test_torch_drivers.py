"""The port's quasi-Newton drivers on the CPU against qoc_tpu's: the native
L-BFGS against ``optax.lbfgs(memory_size=15)`` in float64 (the two-loop
recursion and the zoom linesearch, failures included), its runner and the
scipy bridge against qoc_tpu's on the pi pulse, and ``Grape`` with every
method name at tests/test_grape_e2e.py's bars."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import qoc_tpu as q
import qoc_tpu_torch as qt
from qoc_tpu.models.forward import make_forward as q_make_forward
from qoc_tpu.models.system import ControlProblem as QProblem
from qoc_tpu.optim.convergence import ConvergenceSettings as QConv
from qoc_tpu.optim.lbfgs import make_lbfgs_runner as q_make_lbfgs_runner
from qoc_tpu.optim.scipy_bridge import run_scipy_optimizer as q_run_scipy
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.optim.convergence import ConvergenceSettings
from qoc_tpu_torch.optim.lbfgs import (init_memory, lbfgs_direction,
                                       make_lbfgs_runner, zoom_linesearch)
from qoc_tpu_torch.optim.scipy_bridge import run_scipy_optimizer

torch.set_num_threads(1)


# ---- the algorithm against optax, float64 ---------------------------------

def _rosenbrock(xp):
    def f(x):
        return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    return f


def _quadratic(n, seed):
    """A random convex quadratic; at n = 4, seed 0 the iterate reaches the
    minimum within 17 iterations, and from there on the linesearch fails
    (optax at iteration 19 after 17 probes, returning its safeguard): the
    values it compares differ by rounding."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T + 0.1 * np.eye(n)
    b = rng.standard_normal(n)
    x0 = rng.standard_normal(n) * 3

    def fj(x):
        return 0.5 * x @ (jnp.asarray(Q) @ x) - jnp.asarray(b) @ x

    def ft(x):
        return 0.5 * x @ (torch.from_numpy(Q) @ x) - torch.from_numpy(b) @ x
    return fj, ft, x0


CASES = {
    "rosenbrock": lambda: (_rosenbrock(jnp), _rosenbrock(torch),
                           np.random.default_rng(1).standard_normal(8) * 1.5),
    "quadratic": lambda: _quadratic(4, 0),
}


def _optax_iterates(fj, x0, n_iter):
    with jax.enable_x64(True):
        opt = optax.lbfgs(memory_size=15)
        x = jnp.asarray(x0, dtype=jnp.float64)
        state = opt.init(x)
        vg = optax.value_and_grad_from_state(fj)
        xs, probes, failed = [], [], []
        for _ in range(n_iter):
            v, g = vg(x, state=state)
            u, state = opt.update(g, state, x, value=v, grad=g, value_fn=fj)
            x = optax.apply_updates(x, u)
            info = state[2].info
            xs.append(np.asarray(x))
            probes.append(int(info.num_linesearch_steps))
            failed.append(float(info.decrease_error) > 0
                          or float(info.curvature_error) > 0)
    return xs, probes, failed


def _port_iterates(ft, x0, n_iter):
    def vg(x):
        x = x.detach().requires_grad_(True)
        v = ft(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    x = torch.from_numpy(np.array(x0, dtype=np.float64))
    mem = init_memory(x, 15)
    value, grad = vg(x)
    value = float(value)
    xs, probes, failed = [], [], []
    for _ in range(n_iter):
        d, mem = lbfgs_direction(grad, x, mem)
        step, value, grad, count, fail = zoom_linesearch(vg, x, -d, value,
                                                         grad)
        x = x + float(step) * (-d)
        xs.append(x.numpy().copy())
        probes.append(count)
        failed.append(fail)
    return xs, probes, failed


@pytest.mark.parametrize("case", list(CASES))
def test_lbfgs_matches_optax_float64(case):
    """20 iterations: iterates equal to 1e-8, failed linesearches
    included, and the same number of linesearch probes each iteration
    until the quadratic's iterate sits at its minimum (from there the
    probes' decisions compare values that differ by rounding)."""
    fj, ft, x0 = CASES[case]()
    want, want_probes, want_failed = _optax_iterates(fj, x0, 20)
    got, got_probes, got_failed = _port_iterates(ft, x0, 20)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-8,
                                   err_msg=f"iteration {i}")
    n_same = 17 if case == "quadratic" else 20
    assert got_probes[:n_same] == want_probes[:n_same]
    if case == "quadratic":
        # the safeguard path ran in both
        assert any(want_failed[n_same:]) and any(got_failed[n_same:])


def test_lbfgs_first_direction_is_the_capped_gradient():
    """At count 0 the preconditioner is min(1, 1/|g|) I."""
    g = torch.tensor([3.0, 4.0], dtype=torch.float64)
    d, mem = lbfgs_direction(g, torch.zeros(2, dtype=torch.float64),
                             init_memory(torch.zeros(2, dtype=torch.float64)))
    np.testing.assert_allclose(d.numpy(), g.numpy() / 5.0, rtol=1e-15)
    assert mem.count == 1


# ---- the pi pulse at T = 100 -----------------------------------------------

PI_ARGS = (np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
           ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 100,
           [np.array([1, 0], dtype=complex)])
PI_KW = dict(state_transfer=True, maxA=[0.7, 0.7], seed=0)


def _pi_loss_fns():
    _, q_loss = q_make_forward(QProblem.build(*PI_ARGS, **PI_KW), lean=True,
                               engine="scan")
    p = ControlProblem.build(*PI_ARGS, **PI_KW)
    _, loss = make_forward(p, lean=True, engine="scan", device="cpu")
    return p, q_loss, loss


def test_lbfgs_runner_matches_qoc_tpu_on_pi_pulse():
    """One iteration a segment, no stop for 5 iterations: reg_loss rel <=
    1e-4, or within four float32 steps of 1 (4.8e-7) once the loss nears
    the float32 floor of 1 - F (from iteration 2 on, at 5e-6), and u max
    abs <= 1e-4 at each; then both runners reach loss < 1e-4 under the e2e
    settings."""
    p, q_loss, loss = _pi_loss_fns()
    conv = {"rate": 0.01, "update_step": 1, "max_iterations": 100,
            "conv_target": 0.0, "min_grad": 0.0}
    q_init, q_run = q_make_lbfgs_runner(q_loss, QConv.from_dict(conv))
    init, run = make_lbfgs_runner(loss, ConvergenceSettings.from_dict(conv))
    qs = q_init(jnp.asarray(p.u0_base))
    s = init(torch.as_tensor(p.u0_base))
    for i in range(1, 6):
        qs = q_run(qs, jnp.asarray(i, dtype=jnp.int32))
        s = run(s, i)
        assert s.iteration == int(qs.iteration) == i
        want = float(qs.reg_loss)
        assert abs(s.reg_loss - want) <= max(1e-4 * abs(want), 4.8e-7), i
        np.testing.assert_allclose(s.u_base.numpy(), np.asarray(qs.u_base),
                                   rtol=0, atol=1e-4)
        assert s.evaluations >= i

    conv = {"rate": 0.01, "update_step": 50, "max_iterations": 1000,
            "conv_target": 1e-4}
    q_init, q_run = q_make_lbfgs_runner(q_loss, QConv.from_dict(conv))
    init, run = make_lbfgs_runner(loss, ConvergenceSettings.from_dict(conv))
    qs = q_run(q_init(jnp.asarray(p.u0_base)), jnp.asarray(50, jnp.int32))
    s = run(init(torch.as_tensor(p.u0_base)), 50)
    assert bool(qs.done) and s.done
    assert float(qs.loss) < 1e-4 and s.loss < 1e-4


@pytest.mark.parametrize("method", ["L-BFGS-B", "BFGS"])
def test_scipy_bridge_matches_qoc_tpu(method):
    """The first evaluations' loss and gradient within the float32 floor
    (loss 1e-6, gradient 1e-5 of its largest entry), and nit <= nfev."""
    p, q_loss, loss = _pi_loss_fns()
    conv = {"rate": 0.01, "update_step": 50, "max_iterations": 1000,
            "conv_target": 1e-4}
    calls = {"port": [], "qoc_tpu": []}

    def recorder(key):
        def cb(i, fid, reg, g2, uscale, u):
            calls[key].append((i, fid, reg, g2, uscale, np.array(u)))
        return cb

    q_u, q_res = q_run_scipy(q_loss, p.u0_base, QConv.from_dict(conv),
                             method=method, callback=recorder("qoc_tpu"))
    u, res = run_scipy_optimizer(loss, p.u0_base,
                                 ConvergenceSettings.from_dict(conv),
                                 method=method, callback=recorder("port"),
                                 device="cpu")
    assert 0 < res.nit <= res.nfev
    assert len(calls["port"]) == res.nfev
    assert [c[0] for c in calls["port"]] == list(range(res.nfev))
    for (i, fid, reg, g2, us, uu), (qi, qfid, qreg, qg2, qus, quu) in zip(
            calls["port"][:3], calls["qoc_tpu"][:3]):
        assert i == qi
        np.testing.assert_allclose(uu, quu, rtol=0, atol=1e-5)
        assert abs(fid - qfid) <= 1e-6 and abs(reg - qreg) <= 1e-6
        assert abs(g2 - qg2) <= 1e-4 * qg2
        np.testing.assert_allclose(us, qus, atol=1e-6)
    # the gradient itself, at the first probe
    u0 = torch.as_tensor(p.u0_base).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(u0)[0], u0)
    qg = jax.grad(lambda x: q_loss(x)[0])(jnp.asarray(p.u0_base))
    np.testing.assert_allclose(g.numpy(), np.asarray(qg), rtol=0,
                               atol=1e-5 * float(np.abs(qg).max()))
    assert res.fun < 1e-4 and q_res.fun < 1e-4


# ---- Grape with every method name ------------------------------------------

def _run_pi(method, **kw):
    return qt.Grape(
        *PI_ARGS, save=False, show_plots=False, device="cpu",
        convergence={"rate": 0.01, "update_step": 50,
                     "max_iterations": 1000, "conv_target": 1e-4},
        method=method, **PI_KW, **kw)


# tests/test_grape_e2e.py:39, 385, 497: loss < 1e-4 (L-BFGS-B, native
# L-BFGS), < 1e-3 (BFGS)
E2E_BARS = {"L-BFGS-B": 1e-4, "BFGS": 1e-3, "LBFGS": 1e-4,
            "L-BFGS-JAX": 1e-4, "LBFGS-JAX": 1e-4}


@pytest.mark.parametrize("method", list(E2E_BARS))
def test_grape_methods_meet_e2e_bars(method):
    res = _run_pi(method)
    assert res.loss < E2E_BARS[method]
    assert res.uks.shape == (2, 100)
    assert np.max(np.abs(res.uks)) <= 0.7 + 1e-6
    assert res.engine == "scan"
    assert 0 < res.iterations <= res.nfev
    assert abs(res.fidelity_f64 - (1.0 - res.loss)) < 1e-5
    uks, Uf = res
    assert Uf == []


def test_scipy_iterations_are_nit_as_in_qoc_tpu():
    """GrapeResult.iterations is scipy's nit and nfev its evaluations, the
    same counts as qoc_tpu's on the same run."""
    res = _run_pi("L-BFGS-B")
    want = q.Grape(*PI_ARGS, save=False, show_plots=False,
                   convergence={"rate": 0.01, "update_step": 50,
                                "max_iterations": 1000, "conv_target": 1e-4},
                   method="L-BFGS-B", **PI_KW)
    assert (res.iterations, res.nfev) == (want.iterations, want.nfev)
    np.testing.assert_allclose(res.loss, want.loss, atol=2e-6)
    np.testing.assert_allclose(res.uks, want.uks, atol=1e-4)


@pytest.mark.parametrize("method", ["LBFGS", "L-BFGS-B"])
def test_quasi_newton_on_a_gate_matches_qoc_tpu(method):
    """A unitary problem (the Taylor-[6, 2] gate): the port's final loss
    within 1e-5 of qoc_tpu's, both below the bar."""
    args = (np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
            ["x", "y"], q.SIGMA_X, 2.0, 24, [0, 1])
    kw = dict(maxA=[1.0, 1.0], seed=1, Taylor_terms=[6, 2], save=False,
              show_plots=False, method=method,
              convergence={"rate": 0.01, "update_step": 10,
                           "max_iterations": 200, "conv_target": 1e-5})
    want = q.Grape(*args, **kw)
    got = qt.Grape(*args, device="cpu", **kw)
    assert got.loss < 1e-5 and float(want.loss) < 1e-5
    np.testing.assert_allclose(got.loss, want.loss, atol=1e-5)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown method"):
        _run_pi("Newton")
    with pytest.raises(ValueError, match="unknown method"):
        q.Grape(*PI_ARGS, save=False, show_plots=False, method="Newton",
                **PI_KW)
