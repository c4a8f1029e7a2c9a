"""The port's penalty registry (qoc_tpu_torch.models.costs), inner products
and the forward model with penalties, against qoc_tpu on the same inputs
(made with numpy from a seed): values and gradients of each of the seven
penalties, validation errors, and reg_loss with its autograd gradient
against jax.grad on the lean and analysis forwards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as q
from qoc_tpu.models import costs as jc
from qoc_tpu.models.forward import make_forward as j_make_forward
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.ops import inner_products as jip
from qoc_tpu_torch.models import costs as tc
from qoc_tpu_torch.models.forward import INTER_VEC_COSTS, make_forward
from qoc_tpu_torch.models.system import ControlProblem as TorchProblem
from qoc_tpu_torch.ops import inner_products as tip

torch.set_num_threads(1)

K, T, N, V = 2, 24, 3, 2
DT = 0.125


def _arrays(seed=0, dressed=True):
    """ops_weight, inter_vecs, target, envelope and a dressed rotation (an
    orthogonal [2N, 2N]), float32, scaled so each penalty is O(1)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    rot = np.linalg.qr(rng.standard_normal((2 * N, 2 * N)))[0]
    return dict(
        ops_weight=np.sin(rng.standard_normal((K, T))).astype(f),
        inter_vecs=(0.4 * rng.standard_normal((T + 1, 2 * N, V))).astype(f),
        target_vecs=(0.4 * rng.standard_normal((2 * N, V))).astype(f),
        one_minus_gauss=rng.uniform(0.1, 1.0, (K, T)).astype(f),
        v_sorted_iso=rot.astype(f) if dressed else None,
    )


def _ctx(mod, arrays, conv):
    kw = {k: (None if v is None else conv(v)) for k, v in arrays.items()}
    return mod.CostContext(state_num=N, steps=T, dt=DT, total_time=DT * T,
                           **kw)


COST_CASES = {
    "amplitude": {"amplitude": 0.5},
    "envelope": {"envelope": 0.8},
    "dwdt": {"dwdt": 2e-3},
    "d2wdt2": {"d2wdt2": 2e-6},
    "bandpass": {"bandpass": 0.3, "band": [0.5, 2.0]},
    "forbidden": {"forbidden_coeff_list": [2.0, 1.0],
                  "states_forbidden_list": [2, 0]},
    "forbid_dressed": {"forbidden_coeff_list": [2.0],
                       "states_forbidden_list": [1],
                       "forbid_dressed": True},
    "forbidden_alias": {"forbidden": [1.5], "states_forbidden_list": [2]},
    "speed_up": {"speed_up": 1e-3},
}


@pytest.mark.parametrize("name", list(COST_CASES))
def test_penalty_value_and_gradient_match_qoc_tpu(name):
    rc = COST_CASES[name]
    arrays = _arrays()
    # value
    want = float(jc.total_reg_cost(_ctx(jc, arrays, jnp.asarray), rc))
    t_arr = {k: None if v is None else torch.tensor(v)
             for k, v in arrays.items()}
    w = t_arr["ops_weight"].requires_grad_(True)
    iv = t_arr["inter_vecs"].requires_grad_(True)
    got = tc.total_reg_cost(_ctx(tc, t_arr, lambda x: x), rc)
    assert want > 1e-3   # the case exercises its penalty
    np.testing.assert_allclose(float(got.detach()), want, atol=1e-6)

    # gradient in the pulse and in the trajectory
    def j_cost(w_, iv_):
        a = dict(arrays, ops_weight=w_, inter_vecs=iv_)
        return jc.total_reg_cost(_ctx(jc, a, jnp.asarray), rc)

    jw, jiv = jax.grad(j_cost, argnums=(0, 1))(
        jnp.asarray(arrays["ops_weight"]), jnp.asarray(arrays["inter_vecs"]))
    gw, giv = torch.autograd.grad(got, (w, iv), allow_unused=True)
    gw = torch.zeros_like(w) if gw is None else gw
    giv = torch.zeros_like(iv) if giv is None else giv
    np.testing.assert_allclose(gw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(giv.numpy(), np.asarray(jiv), atol=1e-6)


def test_registry_names_match_qoc_tpu():
    assert set(tc.REGISTRY) == set(jc.REGISTRY)
    assert tc._AUX_KEYS == jc._AUX_KEYS


@pytest.mark.parametrize("name", ["forbidden_coeff_list", "speed_up"])
def test_trajectory_costs_need_inter_vecs(name):
    arrays = dict(_arrays(), inter_vecs=None)
    rc = {name: [1.0] if name != "speed_up" else 1.0,
          "states_forbidden_list": [1]}
    with pytest.raises(ValueError, match="use_inter_vecs"):
        tc.REGISTRY[name](_ctx(tc, arrays, torch.tensor), rc)


VALIDATION_CASES = {
    "typo": {"amplitud": 0.1},
    "lengths": {"forbidden_coeff_list": [1.0, 2.0],
                "states_forbidden_list": [1]},
    "no_levels": {"forbidden": [1.0]},
    "level_range": {"forbidden_coeff_list": [1.0],
                    "states_forbidden_list": [3]},
    "bandpass_without_band": {"bandpass": 0.1},
}


@pytest.mark.parametrize("name", list(VALIDATION_CASES))
def test_validate_reg_coeffs_raises_like_qoc_tpu(name):
    rc = VALIDATION_CASES[name]
    with pytest.raises((KeyError, ValueError)) as want:
        jc.validate_reg_coeffs(rc, state_num=N)
    with pytest.raises(want.type) as got:
        tc.validate_reg_coeffs(rc, state_num=N)
    if name == "typo":
        assert "did you mean 'amplitude'" in str(got.value)
    tc.validate_reg_coeffs(COST_CASES["forbidden"], state_num=N)
    tc.validate_reg_coeffs(None)


def test_total_reg_cost_unknown_key_and_empty():
    arrays = _arrays()
    ctx = _ctx(tc, arrays, torch.tensor)
    assert float(tc.total_reg_cost(ctx, None)) == 0.0
    with pytest.raises(KeyError, match="did you mean 'dwdt'"):
        tc.total_reg_cost(ctx, {"dwdtt": 1.0})
    assert tc.cost_names({"forbidden_coeff_list": [1.0],
                          "states_forbidden_list": [2], "dwdt": 0.1,
                          "band": [0, 1]}) == ["forbidden", "dwdt"]


def test_inner_products_match_qoc_tpu():
    rng = np.random.default_rng(3)
    a1, b1 = (rng.standard_normal((2 * N,)).astype(np.float32)
              for _ in range(2))
    a3, b3 = (rng.standard_normal((T, 2 * N, V)).astype(np.float32)
              for _ in range(2))
    np.testing.assert_allclose(
        float(tip.inner_product_1d(torch.tensor(a1), torch.tensor(b1), N)),
        float(jip.inner_product_1d(jnp.asarray(a1), jnp.asarray(b1), N)),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(tip.inner_product_3d(torch.tensor(a3), torch.tensor(b3), N)),
        float(jip.inner_product_3d(jnp.asarray(a3), jnp.asarray(b3), N)),
        rtol=1e-5)


# ---- the forward model with penalties --------------------------------------


def _leakage(state_transfer):
    """3-level ladder with a leakage level (tests/test_mega.py:78-96)."""
    n = 3
    a = q.annihilate(n)
    H0 = np.diag([0.0, 1.0, 1.95]) * 2 * np.pi
    ops = [a + a.conj().T, 1j * (a - a.conj().T)]
    if state_transfer:
        psi0 = np.zeros(n, complex)
        psi0[0] = 1
        tgt = np.zeros(n, complex)
        tgt[1] = 1
        return ((H0, ops, ["x", "y"], [tgt], 3.0, 20, [psi0]),
                dict(state_transfer=True, maxA=[0.5, 0.5], seed=0))
    return ((H0, ops, ["x", "y"], q.transmon_gate(q.SIGMA_X, n), 3.0, 20,
             [0, 1]), dict(maxA=[0.5, 0.5], seed=0))


FORWARD_RC = {
    "trajectory": {"forbidden_coeff_list": [5.0],
                   "states_forbidden_list": [2], "speed_up": 0.5},
    "all_seven": {"amplitude": 0.05, "envelope": 0.02, "dwdt": 0.001,
                  "d2wdt2": 1e-7, "bandpass": 0.2, "band": [0.5, 2.0],
                  "forbidden_coeff_list": [2.0],
                  "states_forbidden_list": [2], "speed_up": 0.5},
}


@pytest.mark.parametrize("rc_name", list(FORWARD_RC))
@pytest.mark.parametrize("lean", [True, False], ids=["lean", "analysis"])
@pytest.mark.parametrize("state_transfer", [True, False],
                         ids=["state", "unitary"])
def test_forward_reg_loss_and_gradient_match_qoc_tpu(state_transfer, lean,
                                                     rc_name):
    rc = FORWARD_RC[rc_name]
    args, kwargs = _leakage(state_transfer)
    jp = ControlProblem.build(*args, **kwargs)
    tp = TorchProblem.build(*args, **kwargs)
    _, j_loss = j_make_forward(jp, reg_coeffs=rc, engine="scan", lean=lean)
    (want, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(jp.u0_base))
    _, loss_fn = make_forward(tp, reg_coeffs=rc, engine="scan", lean=lean)
    u = torch.tensor(tp.u0_base, requires_grad=True)
    got, out = loss_fn(u)
    (g,) = torch.autograd.grad(got, u)
    assert float(want) - float(j_out.loss) > 1e-3   # penalties are on
    np.testing.assert_allclose(float(got.detach()), float(want), atol=2e-5)
    np.testing.assert_allclose(float(out.loss.detach()), float(j_out.loss),
                               atol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_grad), rtol=2e-3,
                               atol=1e-6)
    assert (out.inter_vecs is None) == (j_out.inter_vecs is None)


def test_lean_forward_keeps_states_only_for_trajectory_costs():
    args, kwargs = _leakage(True)
    tp = TorchProblem.build(*args, **kwargs)
    u = torch.tensor(tp.u0_base)
    _, pulse_only = make_forward(tp, reg_coeffs={"dwdt": 0.01}, lean=True)
    assert pulse_only(u)[1].inter_vecs is None
    for key in INTER_VEC_COSTS:
        rc = ({"speed_up": 1.0} if key == "speed_up"
              else {key: [1.0], "states_forbidden_list": [2]})
        _, traj = make_forward(tp, reg_coeffs=rc, lean=True)
        assert traj(u)[1].inter_vecs.shape == (tp.steps + 1, 6, 1)
