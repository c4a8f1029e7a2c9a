"""The plain reference (benchmark/reference/grape.py) against closed forms,
scipy and finite differences, on the CPU."""

import numpy as np
import pytest
import scipy.linalg
import torch

from benchmark.reference import grape as R

SX = np.array([[0, 1], [1, 0]], dtype=complex)


def _herm(rng, n, scale=1.0):
    h = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return scale * (h + h.conj().T) / 2


def test_expm_and_frechet_match_scipy():
    rng = np.random.default_rng(1)
    A = -1j * 1.3 * _herm(rng, 7)
    E = rng.normal(size=(7, 7)) + 1j * rng.normal(size=(7, 7))
    P = R.expm(torch.as_tensor(A), R.FLOAT64).numpy()
    L = R.expm_frechet(torch.as_tensor(A), torch.as_tensor(E),
                       R.FLOAT64).numpy()
    assert np.abs(P - scipy.linalg.expm(A)).max() < 1e-13
    assert np.abs(L - scipy.linalg.expm_frechet(
        A, E, compute_expm=False)).max() < 1e-12


@pytest.mark.parametrize("theta_T", [np.pi / 2, 0.7, 2.1])
def test_resonant_rabi_rotation(theta_T):
    """A constant sigma_x drive of strength theta for a time T leaves
    |1> with sin^2(theta T): the loss is cos^2(theta T), and 0 for the
    pi pulse."""
    T, total = 40, 5.0
    prob = R.problem_from_system({
        "H0": np.zeros((2, 2)), "Hops": [SX], "target": [np.array([0, 1])],
        "states": [np.array([1, 0])], "state_transfer": True,
        "total_time": total, "steps": T, "maxA": [1.0], "reg_coeffs": {}})
    u = torch.full((1, 1, T), float(np.arcsin(theta_T / total)),
                   dtype=torch.float64)
    loss, reg, _ = R.loss_and_grad(prob, u)
    assert abs(float(loss[0]) - np.cos(theta_T) ** 2) < 1e-13
    assert float(reg[0]) == float(loss[0])


def test_x_gate_on_a_qubit_by_a_pi_pulse():
    """The gate form: a pi pulse about x carries |0> to |1> and |1> to
    |0> up to one global phase, so the coherent gate loss is 0."""
    T, total = 30, 3.0
    prob = R.problem_from_system({
        "H0": np.zeros((2, 2)), "Hops": [SX], "target": SX, "states": [0, 1],
        "state_transfer": False, "total_time": total, "steps": T,
        "maxA": [1.0], "reg_coeffs": {}})
    u = torch.full((1, 1, T), float(np.arcsin(np.pi / 2 / total)),
                   dtype=torch.float64)
    loss, _, _ = R.loss_and_grad(prob, u)
    assert abs(float(loss[0])) < 1e-13


def _small_problem(rng, rc, extra=True):
    N, K = 4, 2
    return R.problem_from_system({
        "H0": _herm(rng, N, 0.5), "Hops": [_herm(rng, N, 0.5)
                                           for _ in range(K)],
        "target": np.eye(N)[:, [1, 0, 2, 3]], "states": [0, 1],
        "state_transfer": False, "total_time": 3.0, "steps": 12,
        "maxA": [1.5, 0.8], "reg_coeffs": rc,
        "extra_ops": [_herm(rng, N)] if extra else None}, swept=extra)


ALL_COSTS = {"dwdt": 0.01, "forbidden_coeff_list": [3.0, 2.0],
             "states_forbidden_list": [2, 3]}
# one cost each, sized so that it moves the gradient as much as the loss;
# the band's bins are [0, 2) and [4, 6) of the 12 steps of 3 time units
ONE_COST = {"envelope": {"envelope": 0.5},
            "bandpass": {"bandpass": 0.2, "band": [0.7, 1.4]},
            "speed_up": {"speed_up": 0.05}}
GRAD_CASES = {"fidelity": {}, "all_costs": ALL_COSTS, **ONE_COST}


@pytest.mark.parametrize("rc", list(GRAD_CASES.values()),
                         ids=list(GRAD_CASES))
def test_gradient_matches_finite_differences(rc):
    rng = np.random.default_rng(2)
    prob = _small_problem(rng, rc)
    u = torch.as_tensor(rng.normal(size=(2, 2, 12)) * 0.5)
    w = torch.as_tensor([[0.3], [-0.2]], dtype=torch.float64)
    _, _, g = R.loss_and_grad(prob, u, w)
    h, worst = 1e-6, 0.0
    for idx in np.ndindex(*u.shape):
        up, um = u.clone(), u.clone()
        up[idx] += h
        um[idx] -= h
        fd = (R.loss_and_grad(prob, up, w, want_grad=False)[1][idx[0]]
              - R.loss_and_grad(prob, um, w, want_grad=False)[1][idx[0]]
              ) / (2 * h)
        worst = max(worst, abs(float(fd - g[idx])))
    assert worst < 1e-7 * max(1.0, float(g.abs().max()))


def _iso(x: np.ndarray) -> torch.Tensor:
    """Complex vectors [..., N, V] in the port's real form [..., 2N, V]."""
    return torch.as_tensor(np.concatenate([x.real, x.imag], axis=-2))


@pytest.mark.parametrize("name", sorted(ONE_COST))
def test_each_cost_is_the_ports_cost(name):
    """The reference's value of each cost (reg_loss - loss) against the
    port's ``models/costs.py`` at float64, on the same seeded pulses and
    the reference's trajectory; the envelope's mask is the one the port's
    problem builds (float32), and the reference's own mask matches it."""
    from qoc_tpu_torch.models.costs import REGISTRY, CostContext
    from qoc_tpu_torch.models.system import ControlProblem

    rng = np.random.default_rng(5)
    rc = ONE_COST[name]
    prob = _small_problem(rng, rc, extra=False)
    u = torch.as_tensor(rng.normal(size=(3, 2, 12)) * 0.5)
    loss, reg, _ = R.loss_and_grad(prob, u, want_grad=False)
    traj = R.propagate(prob, u)[2].numpy()
    N, T = prob.H0.shape[0], prob.steps
    cp = ControlProblem.build(prob.H0, list(prob.Hops), ["a", "b"],
                              np.eye(N)[:, [1, 0, 2, 3]], prob.total_time,
                              T, [0, 1], maxA=list(prob.maxA), seed=0)
    mask = np.asarray(cp.one_minus_gauss, dtype=np.float64)
    assert np.abs(mask - R.gauss_mask(T)[None]).max() < 1e-7
    for s in range(len(u)):
        ctx = CostContext(ops_weight=torch.sin(u[s]),
                          inter_vecs=_iso(traj[s]),
                          target_vecs=_iso(prob.targets), state_num=N,
                          steps=T, dt=prob.dt, total_time=prob.total_time,
                          one_minus_gauss=torch.as_tensor(mask),
                          v_sorted_iso=None)
        theirs = float(REGISTRY[name](ctx, rc))
        mine = float(reg[s] - loss[s])
        assert theirs > 1e-4
        assert abs(mine - theirs) <= 1e-6 * theirs, (s, mine, theirs)


def test_blocks_give_the_same_numbers():
    rng = np.random.default_rng(3)
    prob = _small_problem(rng, ALL_COSTS)
    u = torch.as_tensor(rng.normal(size=(5, 2, 12)) * 0.5)
    w = torch.as_tensor(rng.normal(size=(5, 1)))
    whole = R.loss_and_grad(prob, u, w)
    blocked = R.loss_and_grad_blocked(prob, u, w, max_matrices=24)
    for a, b in zip(whole, blocked):
        assert torch.allclose(a, b, rtol=0, atol=1e-14)


def test_adam_steps_follow_tf1_adam_and_freeze():
    """One seed by hand: the first step moves each entry by the rate
    times g / (|g| + eps); a seed at max_iterations does not move."""
    rng = np.random.default_rng(4)
    prob = _small_problem(rng, {}, extra=False)
    u0 = torch.as_tensor(rng.normal(size=(1, 2, 12)) * 0.5)
    conv = {"rate": 0.02, "conv_target": 1e-12, "max_iterations": 1}
    r = R.adam_steps(prob, u0, conv, n_steps=2)
    _, _, g = R.loss_and_grad(prob, u0)
    expect = u0 - 0.02 * g / (g.abs() + 1e-8)
    assert torch.allclose(r["u"], expect, rtol=0, atol=1e-14)
    assert bool(r["frozen"][0])
    assert torch.allclose(r["grad0"], g, rtol=0, atol=1e-15)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, -3.0e-5],
                     dtype=torch.float32)
    y = R.tf32_round(x)
    assert float(y[0]) == 1.0 + 2 ** -10
    assert float(y[1]) == 1.0 + 2 ** -10          # rounds up
    rel = abs(float(y[2]) - float(x[2])) / abs(float(x[2]))
    assert rel <= 2 ** -11


def test_seed_pulses_are_the_batch_entry_draws():
    """The reference draws the batch entry's initial pulses by the
    documented formula; the entry's own draw gives the same bits."""
    from qoc_tpu_torch.parallel.batch import init_seeds

    class P:
        ops_len, steps = 3, 50

    seed = 2 ** 40 + 17
    mine = R.draw_seed_pulses(6, 3, 50, seed)
    theirs = init_seeds(P, 6, torch.Generator().manual_seed(seed))
    assert torch.equal(mine, theirs)
