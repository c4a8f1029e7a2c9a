"""qoc_tpu_torch.Grape end to end on the CPU against qoc_tpu.Grape: the pi
pulse and the Taylor-[6, 2] gate through the scan engine and through the
fused segment (plain version on the CPU, interpreted Pallas kernel in
qoc_tpu), with and without penalties, and h5 run files that qoc_tpu's
verifier accepts."""

import numpy as np
import pytest
import torch

import qoc_tpu as q
import qoc_tpu_torch as qt

torch.set_num_threads(1)

CONV = {"rate": 0.01, "update_step": 10, "max_iterations": 30,
        "conv_target": 1e-8}


def _pi_pulse():
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, 64,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[2 * np.pi * 0.1] * 2, seed=0))


def _gate():
    return ((np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
             ["x", "y"], q.SIGMA_X, 2.0, 24, [0, 1]),
            dict(maxA=[1.0, 1.0], seed=1, Taylor_terms=[6, 2]))


@pytest.mark.parametrize("engine", ["scan", "mega"])
@pytest.mark.parametrize("make", [_pi_pulse, _gate], ids=["pi_pulse", "gate"])
def test_grape_matches_qoc_tpu(make, engine):
    args, kwargs = make()
    common = dict(convergence=CONV, save=False, show_plots=False,
                  engine=engine, **kwargs)
    want = q.Grape(*args, **common)
    got = qt.Grape(*args, device="cpu", **common)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.loss, want.loss, atol=2e-5)
    np.testing.assert_allclose(got.uks, np.asarray(want.uks), atol=1e-4)
    np.testing.assert_allclose(got.unitary_scale, want.unitary_scale,
                               atol=1e-4)
    np.testing.assert_allclose(got.fidelity_f64, want.fidelity_f64,
                               atol=2e-5)
    if kwargs.get("state_transfer"):
        assert got.Uf == []
    else:
        np.testing.assert_allclose(got.Uf, want.Uf, atol=1e-4)
    assert got.inter_vecs.shape == np.asarray(want.inter_vecs).shape
    np.testing.assert_allclose(got.inter_vecs, np.asarray(want.inter_vecs),
                               atol=1e-4)


def test_engine_routing_on_cpu(capsys):
    args, kwargs = _pi_pulse()
    common = dict(convergence=dict(CONV, max_iterations=2), save=False,
                  show_plots=False, device="cpu", **kwargs)
    assert qt.Grape(*args, **common).engine == "scan"
    assert qt.Grape(*args, engine="mega", **common).engine.startswith("mega")
    assert qt.Grape(*args, engine="tree", **common).engine == "tree"
    out = capsys.readouterr().out
    assert "[qoc-tpu-torch] engine: scan (fallback: cpu device" in out


def test_evolve_matches_qoc_tpu():
    args, kwargs = _gate()
    common = dict(method="EVOLVE", save=False, show_plots=False, **kwargs)
    want = q.Grape(*args, **common)
    got = qt.Grape(*args, device="cpu", **common)
    assert got.iterations == 0
    np.testing.assert_allclose(got.loss, want.loss, atol=1e-5)
    np.testing.assert_allclose(got.inter_vecs, np.asarray(want.inter_vecs),
                               atol=1e-5)


def test_saved_run_passes_qoc_tpu_verifier(tmp_path):
    from qoc_tpu.utils.verification import verify_run

    args, kwargs = _pi_pulse()
    res = qt.Grape(*args, convergence=CONV, save=True, show_plots=False,
                   file_name="pi_pulse", data_path=str(tmp_path),
                   device="cpu", **kwargs)
    assert res.file_path is not None
    out = verify_run(res.file_path, atol=1e-3)
    assert all(out["all_close"]), out
    import h5py

    with h5py.File(res.file_path, "r") as hf:
        assert int(np.array(hf["iteration"])[-1]) == res.iterations
        np.testing.assert_allclose(np.array(hf["uks"])[-1], res.uks)
        assert float(np.array(hf["fidelity_f64"])) == res.fidelity_f64


def test_save_without_h5py_raises(monkeypatch, tmp_path):
    from qoc_tpu_torch.utils import h5

    monkeypatch.setattr(h5, "HAVE_H5PY", False)
    args, kwargs = _pi_pulse()
    with pytest.raises(ImportError, match="h5py"):
        qt.Grape(*args, convergence=CONV, save=True, file_name="x",
                 data_path=str(tmp_path), device="cpu", **kwargs)


@pytest.mark.parametrize("entry", ["grape", "batched_grape_adam"])
def test_device_none_needs_the_card(entry, monkeypatch):
    """``device=None`` runs on the CUDA card: without one the entry points
    raise instead of carrying on on the CPU."""
    from qoc_tpu_torch.models.system import ControlProblem
    from qoc_tpu_torch.parallel.batch import batched_grape_adam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, kwargs = _pi_pulse()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "grape":
            qt.Grape(*args, convergence=CONV, save=False, show_plots=False,
                     **kwargs)
        else:
            batched_grape_adam(ControlProblem.build(*args, **kwargs), 2,
                               convergence=CONV)


def _leakage_gate():
    """3-level transmon X gate with a forbidden leakage level (the shape of
    BASELINE config 3, cut to 3 levels and 24 steps)."""
    n = 3
    a = q.annihilate(n)
    H0 = np.diag([0.0, 0.0, -0.2]) * 2 * np.pi
    return ((H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             q.transmon_gate(q.SIGMA_X, n), 3.0, 24, [0, 1]),
            dict(maxA=[1.0, 1.0], seed=0))


GRAPE_COSTS = {
    "leakage": (_leakage_gate, {"forbidden_coeff_list": [10.0],
                                "states_forbidden_list": [2],
                                "dwdt": 0.001}),
    "pi_pulse_shape": (_pi_pulse, {"amplitude": 0.05, "envelope": 0.02,
                                   "d2wdt2": 1e-6}),
}


@pytest.mark.parametrize("engine", ["scan", "mega"])
@pytest.mark.parametrize("case", list(GRAPE_COSTS))
def test_grape_with_penalties_matches_qoc_tpu(case, engine):
    make, rc = GRAPE_COSTS[case]
    args, kwargs = make()
    common = dict(convergence=CONV, save=False, show_plots=False,
                  engine=engine, reg_coeffs=rc, **kwargs)
    want = q.Grape(*args, **common)
    got = qt.Grape(*args, device="cpu", **common)
    assert got.iterations == want.iterations
    assert got.reg_loss > got.loss + 1e-4   # the penalties are on
    np.testing.assert_allclose(got.loss, want.loss, atol=2e-5)
    np.testing.assert_allclose(got.reg_loss, want.reg_loss, atol=2e-5)
    np.testing.assert_allclose(got.uks, np.asarray(want.uks), atol=1e-4)
    np.testing.assert_allclose(got.fidelity_f64, want.fidelity_f64,
                               atol=2e-5)
    np.testing.assert_allclose(got.history.reg_costs,
                               np.asarray(want.history.reg_costs), atol=2e-5)


def test_penalty_routing_on_cpu(capsys):
    args, kwargs = _leakage_gate()
    rc = GRAPE_COSTS["leakage"][1]
    common = dict(convergence=dict(CONV, max_iterations=2), save=False,
                  show_plots=False, device="cpu", reg_coeffs=rc, **kwargs)
    assert qt.Grape(*args, engine="mega", **common).engine == (
        "mega (plain torch segment reference on cpu, penalties: "
        "forbidden, dwdt)")
    # the engine qoc_tpu resolves the same problem to on its CPU backend
    from qoc_tpu.models.system import ControlProblem as JProblem
    from qoc_tpu.routing import resolve_single_engine

    want = resolve_single_engine(JProblem.build(*args, **kwargs), rc,
                                 "exact", "auto", lean=True)
    assert want == "associative"
    assert qt.Grape(*args, **common).engine == want
    out = capsys.readouterr().out
    assert f"[qoc-tpu-torch] engine: {want} (fallback: cpu device" in out
    with pytest.raises(KeyError, match="did you mean 'dwdt'"):
        qt.Grape(*args, **dict(common, reg_coeffs={"dwdtt": 0.1}))
    with pytest.raises(ValueError, match="states_forbidden_list"):
        qt.Grape(*args, **dict(common, reg_coeffs={
            "forbidden_coeff_list": [1.0], "states_forbidden_list": [3]}))


def test_saved_run_records_reg_error(tmp_path):
    import h5py

    args, kwargs = _leakage_gate()
    res = qt.Grape(*args, convergence=CONV, save=True, show_plots=False,
                   file_name="leakage", data_path=str(tmp_path),
                   device="cpu", reg_coeffs=GRAPE_COSTS["leakage"][1],
                   **kwargs)
    with h5py.File(res.file_path, "r") as hf:
        err = np.array(hf["error"])
        reg = np.array(hf["reg_error"])
    assert np.all(reg > err)
    np.testing.assert_allclose(reg[-1], res.reg_loss, rtol=1e-6)
