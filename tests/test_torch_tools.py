"""The port's measurement tools on the CPU: tools/torch_roofline.py's
FLOP counts against ``torch.utils.flop_counter.FlopCounterMode`` over
one loss-and-gradient, tools/torch_uks_divergence.py and
examples/torch_parity_pack.py at T = 40 (the parity pack's array check
against ``verify_run`` on the same run saved to h5), and none of them, nor
bench_torch.py, importing jax, optax, h5py or qoc_tpu."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_torch
from qoc_tpu_torch import Grape
from qoc_tpu_torch.models.forward import make_forward
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss
from qoc_tpu_torch.utils.verification import verify_run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(REPO, "examples", "jobs")


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


roofline = _load("torch_roofline", "tools", "torch_roofline.py")
uks_tool = _load("torch_uks_divergence", "tools", "torch_uks_divergence.py")
parity = _load("torch_parity_pack", "examples", "torch_parity_pack.py")


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _single(p, engine, rc=None):
    """One loss-and-gradient of make_forward's lean loss on ``engine``."""
    _, loss_fn = make_forward(p, rc, engine=engine, lean=True, device="cpu")
    u = torch.as_tensor(np.asarray(p.u0_base, np.float32)).requires_grad_()
    return lambda: torch.autograd.grad(loss_fn(u)[0], u)


def _cols(p, rc, seeds):
    loss = make_xla_batched_loss(p, rc, device="cpu")
    u = torch.randn(seeds, p.ops_len, p.steps).requires_grad_()
    return lambda: torch.autograd.grad(loss(u)[0].sum(), u)


def _small_unitary():
    """A dim-8 gate with 2 squarings: the unitary pscan's 2^s sub-steps."""
    rng = np.random.default_rng(0)

    def herm(n):
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (A + A.conj().T) / 20

    U = np.eye(8, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    return ControlProblem.build(
        np.diag(np.arange(8)).astype(complex) * 0.1,
        [herm(8) for _ in range(3)], ["a", "b", "c"], U, 10.0, 12, [0, 1, 2],
        maxA=[1.0] * 3, seed=0, Taylor_terms=[5, 2])


def _small_dim60():
    """Config 4's system (dim 60) at T = 6 with its three costs."""
    H0, Hops, names = bench_torch.build_system()
    return (bench_torch._dressed_transfer(H0, Hops, names, 4.0, 6,
                                          [bench_torch.MAXA] * 4),
            {"dwdt": 0.0001, "bandpass": 0.1, "band": [0.1, 10.0],
             "speed_up": 0.0001})


def _cases():
    pi = bench_torch._problem(steps=16)
    leak = bench_torch._leakage_problem(steps=10)
    d60, rc60 = _small_dim60()
    gate = _small_unitary()
    return {
        "scan_leakage_costs": (_single(leak, "scan", bench_torch._LEAKAGE_RC),
                               roofline.scan_unitary_count(leak, True)),
        "scan_leakage": (_single(leak, "scan"),
                         roofline.scan_unitary_count(leak, False)),
        "pscan_pi": (_single(pi, "pscan"), roofline.pscan_state_count(pi)),
        "pscan_dim60_costs": (_single(d60, "pscan", rc60),
                              roofline.pscan_state_count(d60)),
        "pscan_unitary": (_single(gate, "pscan"),
                          roofline.pscan_unitary_count(gate)),
        "cols_pi": (_cols(pi, None, 3), roofline.cols_count(pi, 3)),
        "cols_pi_speed_up": (_cols(pi, {"speed_up": 0.001}, 3),
                             roofline.cols_count(pi, 3)),
        "cols_unitary": (_cols(gate, None, 2), roofline.cols_count(gate, 6)),
    }


CASES = ("scan_leakage_costs", "scan_leakage", "pscan_pi",
         "pscan_dim60_costs", "pscan_unitary", "cols_pi", "cols_pi_speed_up",
         "cols_unitary")


@pytest.mark.parametrize("case", CASES)
def test_roofline_flops_match_flop_counter(case):
    """Each per-iteration engine's FLOP count equals FlopCounterMode's
    over one loss-and-gradient at a small shape (on the CPU pscan's Q
    series is the plain series, whose products kernel 7's count
    ``expm_work`` counts)."""
    fn, (flops, nbytes) = _cases()[case]
    assert flops == _flops(fn)
    assert nbytes > 0


def test_roofline_share_and_bound():
    """An iteration at its bound has share 1; the larger of the two times
    names the bound."""
    from chip_smoke import PEAK_BYTES, PEAK_FLOPS

    r = roofline.roofline(PEAK_FLOPS * 1e-3, 1.0, 1e3)
    assert r["bound_by"] == "operations"
    assert abs(r["roofline_share"] - 1.0) < 1e-12
    r = roofline.roofline(1.0, PEAK_BYTES * 2e-3, 250.0)
    assert r["bound_by"] == "bytes" and abs(r["roofline_share"] - 0.5) < 1e-12


@pytest.mark.parametrize("n_iters", [100, bench_torch.MEGA_ITERS])
def test_segment_count_is_the_kernels_line_bound(n_iters):
    """Kernel 3's count in the roofline is ``chip_smoke.segment_work`` of
    one launch over its iterations: the bound of ``n_iters`` iterations
    is ``_segment_bound``'s, the kernels line's, for the same launch.  At
    bench_torch's one launch of the pi pulse the operands are read once
    for all its iterations, so the iteration is bound by operations."""
    from chip_smoke import _segment_bound
    from qoc_tpu_torch.ops.mega import (make_mega_segment_runner,
                                        segment_inputs)

    p = bench_torch._problem()
    flops, nbytes = roofline.segment_count(p, n_iters)
    init_state, _, _ = make_mega_segment_runner(p, bench_torch._conv(),
                                                device="cpu")
    k = init_state(p.u0_base)
    mats, psi0p, _, _, _, order, s = segment_inputs(p, "cpu")
    line = _segment_bound(n_iters, p, mats, psi0p, order, s, k)
    r = roofline.roofline(flops, nbytes, 1.0)
    assert r["bound_by"] == line["bound_by"]
    assert r["bound_ms_per_iter"] * n_iters == pytest.approx(
        line["bound_ms"], rel=1e-12)
    if n_iters == bench_torch.MEGA_ITERS:
        assert r["bound_by"] == "operations"


def _short_job(tmp_path, name, steps=40, **conv):
    """A copy of examples/jobs/<name>.json at ``steps`` steps."""
    with open(os.path.join(JOBS, f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["steps"] = steps
    cfg["convergence"] = dict(cfg["convergence"], **conv)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_uks_divergence_at_t40(tmp_path):
    """The CNOT at T = 40: kernel 3's plain version against the scan
    engine from the same u0, two rows of 10 iterations; the iteration-0
    gradients agree to 1e-5 of their scale and both curves are finite."""
    rep = uks_tool.divergence_curves(_short_job(tmp_path, "cnot"),
                                     n_iters=20, stride=10, device="cpu")
    assert rep["engines"] == "mega vs scan"
    assert [r["iteration"] for r in rep["rows"]] == [10, 20]
    assert rep["grad_iter0_max_abs_dev"] <= 1e-5 * rep["grad_iter0_scale"]
    for r in rep["rows"]:
        assert np.isfinite(r["cross_engine"]) and r["cross_engine"] < 1e-2
        assert np.isfinite(r["ulp_control"]) and r["ulp_control"] < 1e-2


def test_parity_pack_at_t40(tmp_path, capsys):
    """spin_pi at T = 40 through the pack: the oracle fidelity's float64
    delta below 1e-6, the states all_close at 1e-4, the kernel-3-vs-scan
    prefix finite and labelled with the engine that ran;
    PARITY_RESULTS.json only under ``out``."""
    _short_job(tmp_path, "spin_pi", max_iterations=150)
    res = parity.run_pack(["spin_pi"], device="cpu", jobs_dir=str(tmp_path))
    assert not (tmp_path / "PARITY_RESULTS.json").exists()
    (r,) = res
    assert r["oracle_fidelity_delta_f64"] < 1e-6
    assert r["verify_expm_all_close"] and r["verify_ode_all_close"]
    assert np.isfinite(r["uks_prefix_200_max_dev"])
    assert r["uks_prefix_engines"].startswith("mega")
    assert r["uks_prefix_engines"].endswith(" vs scan")
    parity.run_pack(["spin_pi"], device="cpu", jobs_dir=str(tmp_path),
                    outdir=str(tmp_path / "out"))
    with open(tmp_path / "out" / "PARITY_RESULTS.json") as f:
        assert json.load(f)[0]["config"] == "spin_pi"
    assert "| spin_pi | 40 |" in capsys.readouterr().out


@pytest.mark.parametrize("oracle", ["scipy", "ode"])
def test_array_check_is_verify_run(tmp_path, oracle):
    """The pack's check on a result's arrays gives verify_run's
    max_abs_diff and all_close on the same run saved to h5, and its oracle
    fidelity the h5-reading oracle of examples/parity_pack.py."""
    from qoc_tpu_torch.utils.jobs import load_job

    cfg = load_job(_short_job(tmp_path, "spin_pi", max_iterations=60))
    cfg.update(show_plots=False, save=True, data_path=str(tmp_path),
               file_name="pack")
    res = Grape(**cfg, device="cpu")
    got = parity.verify_result(cfg, res, oracle=oracle)
    assert got == verify_run(res.file_path, atol=1e-4, oracle=oracle)
    if oracle == "scipy":
        qoc_pack = _load("parity_pack", "examples", "parity_pack.py")
        assert parity.oracle_fidelity(cfg, res) == pytest.approx(
            qoc_pack.oracle_fidelity(res.file_path), abs=1e-12)


def test_entry_points_import_no_jax():
    """bench_torch.py, the roofline and uks tools and the parity pack
    import neither jax, optax, h5py nor qoc_tpu."""
    code = (
        "import importlib.util, sys\n"
        "import bench_torch\n"
        "for name, path in (('r', 'tools/torch_roofline.py'),\n"
        "                   ('u', 'tools/torch_uks_divergence.py'),\n"
        "                   ('p', 'examples/torch_parity_pack.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in ('jax', 'optax', 'h5py', 'qoc_tpu')\n"
        "       if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("main", [roofline.main, uks_tool.main,
                                  parity.main],
                         ids=["roofline", "uks", "parity"])
def test_tools_need_the_card(main, capsys, monkeypatch):
    """Without a card and without ``--device cpu``: exit 2, no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([]) == 2
    assert capsys.readouterr().out == ""
