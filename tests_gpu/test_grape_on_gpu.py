"""End-to-end ``qoc_tpu_torch.Grape`` on the card (the counterpart of
tests_tpu/test_grape_on_tpu.py, test for test, at its tolerances).

The public API path on the card: the routing onto the fused segment
kernel (kernel 3, with its launch counted), independent-oracle
verification of the run's intermediate states (scipy's Pade expm and an
adaptive ODE solver, float64), the save/resume round trip through an h5
run file, and the leakage flagship (reg_coeffs through ``Grape``) against
the scan engine on the same card.

The card's machine has no h5py: the pi-pulse run checks the result's
arrays (``verify_states``) instead of a saved file, and the round trip
skips there (chip_smoke.py's phase 9b holds resume on the card bit for
bit through the checkpoint's numpy leaves).
"""

import numpy as np
import pytest

from conftest import gap, launches

import qoc_tpu_torch as q
from qoc_tpu_torch.ops.mega import mega_supported
from qoc_tpu_torch.utils.analysis import inter_vecs_to_complex
from qoc_tpu_torch.utils.verification import verify_states

pytestmark = pytest.mark.gpu

H0_QUBIT = np.zeros((2, 2), dtype=complex)
PI_OPS = [q.SIGMA_X, q.SIGMA_Y]


def _pi_pulse(device, max_iterations, **kw):
    """The pi pulse at T = 100 on the card's route: ``engine="auto"``
    routes to kernel 3 on the card; on the CPU lane ``"mega"`` runs the
    kernel's plain version (``"auto"`` would take the scan engine there,
    whose float32 loss reaches 0 < conv_target at iteration 194)."""
    kw.setdefault("engine", "auto" if device.type == "cuda" else "mega")
    return q.Grape(
        H0_QUBIT, PI_OPS, ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, 100,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, show_plots=False,
        convergence={"rate": 0.01, "update_step": 20,
                     "max_iterations": max_iterations,
                     "conv_target": 1e-12},
        maxA=[0.7, 0.7], seed=0, method="Adam", device=device, **kw,
    )


def test_grape_pi_pulse_api_on_gpu(device, record_property):
    """Full public-API run: converges, routes to kernel 3 on the card, and
    the run's intermediate states pass BOTH independent float64 oracles
    (scipy Pade expm + adaptive ODE)."""
    with launches(device, "mega_segment"):
        res = _pi_pulse(device, 200, save=False)
    assert mega_supported(res.problem)
    if device.type == "cuda":
        assert res.engine.startswith("mega (fused Adam segment CUDA kernel")
    record_property("loss", res.loss)
    assert res.loss < 1e-3, res.loss
    assert res.iterations >= 200

    p = res.problem
    for oracle in ("scipy", "ode"):
        rep = verify_states(H0_QUBIT, np.asarray(PI_OPS), res.uks,
                            p.total_time, p.steps, p.initial_vectors_c,
                            inter_vecs_to_complex(p, res.inter_vecs),
                            atol=1e-4, oracle=oracle)
        record_property(f"{oracle}_max_abs_diff", max(rep["max_abs_diff"]))
        assert all(rep["all_close"]), (oracle, rep)
        assert max(rep["max_abs_diff"]) < 1e-4, (oracle, rep)


def test_grape_save_resume_roundtrip_on_gpu(device, tmp_path):
    """A checkpoint written by a kernel-3 run resumes into a second run and
    keeps optimizing (utils.checkpoint through the public API)."""
    pytest.importorskip("h5py")

    def run(name, n, resume_from=None):
        return _pi_pulse(device, n, save=True, file_name=name,
                         data_path=str(tmp_path), resume_from=resume_from)

    res1 = run("gpu_resume_a", 60)
    it1, loss1 = res1.iterations, res1.loss
    res2 = run("gpu_resume_b", 160, resume_from=res1.file_path)
    assert res2.iterations > it1
    assert res2.loss <= loss1 + 1e-6, (res2.loss, loss1)


def test_grape_leakage_flagship_on_gpu(device, record_property):
    """The leakage flagship (forbidden-state costs + dwdt through
    reg_coeffs): kernel 3's costs instance must reproduce the scan engine
    run on the same card."""
    levels = 5
    a = q.annihilate(levels)
    ad = a.conj().T
    H0 = (-0.2 * 2 * np.pi / 2) * (ad @ ad @ a @ a)
    Hops = [a + ad, 1j * (a - ad)]
    X_gate = q.transmon_gate(q.SIGMA_X, levels)
    reg = {"forbidden_coeff_list": [10.0, 10.0, 10.0],
           "states_forbidden_list": [2, 3, 4], "dwdt": 0.001}
    kw = dict(
        reg_coeffs=reg,
        convergence={"rate": 0.02, "update_step": 50,
                     "max_iterations": 100, "conv_target": 1e-12},
        maxA=[2.0, 2.0], seed=0, method="Adam",
        show_plots=False, save=False, device=device,
    )
    with launches(device, "mega_segment_costs"):
        res_mega = q.Grape(H0, Hops, ["x", "y"], X_gate, 6.0, 100, [0, 1],
                           engine="auto", **kw)
    assert mega_supported(res_mega.problem, reg)  # the fast path ran
    res_xla = q.Grape(H0, Hops, ["x", "y"], X_gate, 6.0, 100, [0, 1],
                      engine="scan", **kw)
    # the same 100-iteration trajectory from both implementations
    record_property("loss_gap", abs(res_mega.loss - res_xla.loss))
    record_property("u_gap", gap(res_mega.u_base, res_xla.u_base))
    record_property("uks_gap", gap(res_mega.uks, res_xla.uks))
    np.testing.assert_allclose(res_mega.loss, res_xla.loss,
                               rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(res_mega.u_base), np.asarray(res_xla.u_base), atol=5e-3)
    np.testing.assert_allclose(res_mega.uks, res_xla.uks, atol=5e-3)
