"""BASELINE config 5 (dim 200, a detuning sweep through ``xla-cols``) in
the port against qoc_tpu, at full width on the CPU: the problem of
examples/torch_05_pod_scale_sweep.py against examples/05's bit for bit,
and the column-batched loss and gradient with the detuning channel
against ``qoc_tpu.parallel.xla_batch``'s."""

import dataclasses
import importlib.util
import json
import os

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoc_tpu.models.system import ControlProblem
from qoc_tpu.ops.isomorphism import c_to_r_mat
from qoc_tpu.parallel.xla_batch import make_xla_batched_loss as qoc_loss
from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, *path):
    """A script of the repo as a module (examples import from the repo
    root and have no package)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return (_load("qoc_tpu_example_05", "examples", "05_pod_scale_sweep.py"),
            _load("torch_example_05", "examples",
                  "torch_05_pod_scale_sweep.py"))


def _assert_same(a, b, name):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            _assert_same(x, y, name)
    else:
        assert a == b, name


def test_build_dim200_bit_identical(examples):
    old, new = examples
    ref, n_ref = old.build_dim200()
    got, n_got = new.build_dim200()
    assert (got.state_num, got.steps, got.taylor_terms) == (200, 200, 10)
    for f in dataclasses.fields(ControlProblem):
        _assert_same(getattr(got, f.name), getattr(ref, f.name), f.name)
    np.testing.assert_array_equal(n_got, n_ref)
    # the detuning channel and grid of qoc_tpu's run_full
    extra, deltas, grid = new.detuning_channel(got, n_got, 4096, 64)
    np.testing.assert_array_equal(
        extra, np.stack([c_to_r_mat(-1j * ref.dt * n_ref)]).astype(
            np.float32))
    want_grid = np.linspace(-0.1, 0.1, 64).astype(np.float32)
    np.testing.assert_array_equal(grid, want_grid)
    np.testing.assert_array_equal(
        deltas, want_grid[np.arange(4096) % 64][:, None])


def test_xla_cols_matches_qoc_tpu_at_full_width(examples):
    """4 seeds at dim 200, T = 200, with the detuning channel: the same
    float32 reg_loss bits and gradients within 2e-6 of max|g| (measured on
    this CPU: reg_loss equal, gradient 1.6e-7 of max|g|; the port's
    float32 against its float64 of the same arithmetic 1.4e-8 and
    6.7e-7)."""
    old, new = examples
    p_ref, n_ref = old.build_dim200()
    p, n_op = new.build_dim200()
    extra, deltas, _ = new.detuning_channel(p, n_op, 4, 64)
    rng = np.random.default_rng(0)
    u = (rng.standard_normal((4, 3, 200)) / np.sqrt(200)).astype(np.float32)

    ref_loss = qoc_loss(p_ref, None, extra_channel_mats=extra)
    reg_ref, fid_ref = ref_loss(jnp.asarray(u), jnp.asarray(deltas))
    g_ref = jax.grad(lambda x: jnp.sum(ref_loss(x, jnp.asarray(deltas))[0]))(
        jnp.asarray(u))
    reg_ref, fid_ref, g_ref = map(np.asarray, (reg_ref, fid_ref, g_ref))

    loss = make_xla_batched_loss(p, None, extra_channel_mats=extra,
                                 device="cpu")
    ut = torch.tensor(u, requires_grad=True)
    reg, fid = loss(ut, torch.as_tensor(deltas))
    (g,) = torch.autograd.grad(reg.sum(), ut)

    assert reg.shape == (4,) and np.all(np.isfinite(g.numpy()))
    np.testing.assert_allclose(reg.detach().numpy(), reg_ref, rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(fid.detach().numpy(), fid_ref, rtol=0,
                               atol=1e-7)
    assert np.abs(g.numpy() - g_ref).max() <= 2e-6 * np.abs(g_ref).max()


def test_float32_floor_inside_phase_10b_bars(examples):
    """chip_smoke.py phase 10b holds the card's float32 loss and gradient
    at iteration 0 (8 seeds, ``init_seeds`` with seed 0, the first 8
    detunings) against float64 of the same arithmetic.  On the CPU the
    gap sits at least 5x inside its bars (measured: 2.7e-8 in reg_loss
    and 1.06e-6 of max|g|)."""
    from qoc_tpu_torch.parallel.batch import init_seeds

    _, new = examples
    p, n_op = new.build_dim200()
    extra, deltas, _ = new.detuning_channel(p, n_op, 8, 64)
    u = init_seeds(p, 8, torch.Generator().manual_seed(0))
    out = {}
    for dtype in (torch.float32, torch.float64):
        loss = make_xla_batched_loss(p, None, extra_channel_mats=extra,
                                     device="cpu", dtype=dtype)
        ud = u.to(dtype).requires_grad_(True)
        reg, _ = loss(ud, torch.as_tensor(deltas))
        (g,) = torch.autograd.grad(reg.sum(), ud)
        out[dtype] = (reg.detach().double(), g.double())
    (r32, g32), (r64, g64) = out[torch.float32], out[torch.float64]
    loss_gap = float((r32 - r64).abs().max())
    grad_gap = float((g32 - g64).abs().max() / g64.abs().max())
    assert loss_gap <= chip_smoke.C5_LOSS_BAR / 5, loss_gap
    assert grad_gap <= chip_smoke.C5_GRAD_BAR / 5, grad_gap


def test_sweep_script_reports_on_the_cpu(examples, tmp_path, capsys):
    """The script end to end at 2 seeds in two chunks of one column, one
    iteration: qoc_tpu's report fields and the port's, one JSON line, and
    the file only with ``--out``."""
    _, new = examples
    out = tmp_path / "c5.json"
    rep = new.main(["--seeds", "2", "--grid", "2", "--iters", "1",
                    "--chunk", "1", "--device", "cpu", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert (json.loads(lines[-1]) == json.loads(out.read_text())
            == json.loads(json.dumps(rep)))
    assert sum("batch backend: xla-cols" in ln for ln in lines) == 2
    assert rep["card"] == "cpu" and rep["peak_device_bytes"] is None
    assert (rep["n_seeds"], rep["dim"], rep["steps"]) == (2, 200, 200)
    assert rep["iterations"] == 2 and len(rep["ms_per_chunk_iteration"]) == 2
    assert 0.0 < rep["best_loss"] <= rep["median_loss"] < 1.0
    assert rep["converged_count"] == 0 and rep["solves_per_sec"] == 0.0
    assert set(rep["best_loss_first_8_grid_points"]) == {
        float(np.float32(-0.1)), float(np.float32(0.1))}
