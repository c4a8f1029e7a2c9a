"""The port's distribution layer against qoc_tpu's on the CPU: the mesh
helpers, ``make_shard_map_step`` (its reduced statistics) and
``make_xla_cols_sharded_runner`` on two gloo ranks, against qoc_tpu's
``shard_map`` programs on two of the conftest's eight virtual CPU devices.

The two ranks are worker processes that import only ``qoc_tpu_torch``
(their code is ``WORKER`` below, with the functions that build the
problems shared with this file by source); they rendezvous through a
file under the module's temporary directory and exchange arrays with
this process as ``.npy`` files.  Both ranks run once per module; the
tests read their results.  Inputs are made with numpy from a seed."""

import inspect
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import qoc_tpu as q
import qoc_tpu_torch as qt
from qoc_tpu.optim.convergence import ConvergenceSettings as JConv
from qoc_tpu.parallel.shard import make_shard_map_step as j_shard_step
from qoc_tpu.parallel.xla_batch import (
    make_xla_cols_sharded_runner as j_cols_runner)
from qoc_tpu_torch.optim.convergence import ConvergenceSettings as TConv
from qoc_tpu_torch.parallel import mesh as tmesh
from qoc_tpu_torch.parallel.cols_batch import make_xla_cols_sharded_runner
from qoc_tpu_torch.parallel.shard import make_shard_map_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
# seconds for both ranks to finish; a run that takes longer fails
WORKER_TIMEOUT = 300

SHARD_SEEDS = 8
SHARD_CONV = {"rate": 0.05, "conv_target": 1e-2}
SHARD_STEPS = 40
COLS_SEEDS = 8
COLS_ITERS = 3
COLS_CONV = {"rate": 0.05, "update_step": 100, "max_iterations": 10 ** 6,
             "conv_target": -1.0}
COLS_RC = {"forbidden_coeff_list": [4.0], "states_forbidden_list": [3]}


def pi_problem(m):
    """tests/test_distributed.py's pi pulse (T = 20), in package ``m``."""
    return m.ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [m.SIGMA_X, m.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 8.0, 20,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.8, 0.8], seed=0)


def leakage_problem(m):
    """tests/test_xla_batch.py's 4-level transmon (T = 8) with its detuning
    channel, in package ``m``."""
    a = m.annihilate(4)
    H0 = 2 * np.pi * (-0.2) / 2 * (a.conj().T @ a.conj().T @ a @ a)
    psi0 = np.zeros(4, complex)
    psi0[0] = 1
    tgt = np.zeros(4, complex)
    tgt[1] = 1
    p = m.ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        3.0, 8, [psi0], state_transfer=True, maxA=[1.0, 1.0], seed=0)
    extra = np.stack([np.asarray(
        m.c_to_r_mat(-1j * p.dt * np.diag(np.arange(4.0))))])
    return p, extra.astype(np.float32)


WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, out = int(sys.argv[1]), sys.argv[2]
    import qoc_tpu_torch as qt
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.parallel import mesh as tmesh
    from qoc_tpu_torch.parallel.cols_batch import (
        make_xla_cols_sharded_runner)
    from qoc_tpu_torch.parallel.shard import make_shard_map_step

    def save(name, x):
        np.save(os.path.join(out, f"{name}.r{rank}.npy"), np.asarray(x))

    def load(name):
        return np.load(os.path.join(out, name + ".npy"))

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return ""

    tmesh.init_distributed(
        backend="gloo", world_size=RANKS, rank=rank,
        init_method="file://" + os.path.join(out, "rendezvous"))
    mesh = tmesh.make_mesh()
    save("mesh", [mesh.size(), mesh.get_local_rank()])
    x = torch.arange(24.0).reshape(8, 3)
    part = tmesh.local_shard(x, mesh)
    save("local", part)
    save("gathered", tmesh.gather(part, mesh))
    save("gathered_bool", tmesh.gather(part[:, 0] > 8, mesh))
    save("errors", [error(lambda: tmesh.local_shard(torch.zeros(3), mesh)),
                    error(lambda: tmesh.make_mesh(n_devices=4)),
                    error(lambda: tmesh.make_mesh(devices=[0]))])

    init, step = make_shard_map_step(
        pi_problem(qt), ConvergenceSettings.from_dict(SHARD_CONV), mesh,
        steps_per_call=SHARD_STEPS, device="cpu")
    u, opt = init(load("shard_u0"))
    save("shard_local_seeds", [u.shape[0]])
    for k in range(2):
        u, opt, stats = step(u, opt)
        save(f"shard_stats{k}", [float(v) for v in stats])
        save(f"shard_u{k}", tmesh.gather(u, mesh))

    p, extra = leakage_problem(qt)
    run = make_xla_cols_sharded_runner(
        p, ConvergenceSettings.from_dict(COLS_CONV), mesh,
        reg_coeffs=COLS_RC, extra_channel_mats=extra, device="cpu")
    u, fids, regs = run(load("cols_u0"), COLS_ITERS,
                        extra_weights=load("cols_ew"))
    for name, v in (("u", u), ("fids", fids), ("regs", regs)):
        save("cols_" + name, v)
    save("no_jax", ["jax" not in sys.modules
                    and "qoc_tpu" not in sys.modules])
""")


def run_ranks(tmp, body: str, consts: dict, functions) -> None:
    """Run ``body`` on ``RANKS`` gloo ranks, each a process importing only
    qoc_tpu_torch; fail with the workers' output if one fails or they
    outlast WORKER_TIMEOUT."""
    code = "\n".join(
        ["import numpy as np", f"RANKS = {RANKS}"]
        + [f"{k} = {v!r}" for k, v in consts.items()]
        + [inspect.getsource(f) for f in functions] + [body])
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0].decode() for p in procs]
        pytest.fail(f"the {RANKS} ranks outlasted {WORKER_TIMEOUT} s:\n"
                    + "\n".join(o[-3000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"


def _seeds(S, K, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, K, T)) / np.sqrt(T)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results: ``ranks(name)`` -> [rank 0's, rank 1's]."""
    tmp = tmp_path_factory.mktemp("ranks")
    np.save(tmp / "shard_u0.npy", _seeds(SHARD_SEEDS, 2, 20, 0))
    np.save(tmp / "cols_u0.npy", _seeds(COLS_SEEDS, 2, 8, 12))
    np.save(tmp / "cols_ew.npy",
            np.linspace(-0.2, 0.2, COLS_SEEDS)[:, None].astype(np.float32))
    run_ranks(tmp, WORKER, dict(
        SHARD_CONV=SHARD_CONV, SHARD_STEPS=SHARD_STEPS, COLS_CONV=COLS_CONV,
        COLS_ITERS=COLS_ITERS, COLS_RC=COLS_RC),
        (pi_problem, leakage_problem))

    def read(name):
        return [np.load(tmp / f"{name}.r{r}.npy", allow_pickle=False)
                for r in range(RANKS)]

    read.dir = tmp
    return read


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:RANKS]), ("batch",))


def test_workers_import_no_jax(ranks):
    assert all(bool(v[0]) for v in ranks("no_jax"))


def test_mesh_spans_the_ranks(ranks):
    """make_mesh over an initialised gloo group: one rank per process;
    local_shard gives rank r rows [4r, 4r + 4) and gather puts them
    back on every rank (bool included)."""
    x = np.arange(24.0).reshape(8, 3)
    for r, (mesh, local) in enumerate(zip(ranks("mesh"), ranks("local"))):
        np.testing.assert_array_equal(mesh, [RANKS, r])
        np.testing.assert_array_equal(local, x[4 * r:4 * r + 4])
    for g in ranks("gathered"):
        np.testing.assert_array_equal(g, x)
    for g in ranks("gathered_bool"):
        np.testing.assert_array_equal(g, x[:, 0] > 8)


def test_mesh_errors(ranks):
    """An indivisible seed axis, a device count other than the world size
    and a partial list of ranks each raise, saying why."""
    for shard_err, size_err, ranks_err in ranks("errors"):
        assert "does not divide by the mesh size (2)" in shard_err
        assert "spans the process group's 2 ranks" in size_err
        assert "spans every rank of the process group, 0..1" in ranks_err


def test_mesh_of_one_without_a_process_group():
    """make_mesh() with no process group forms a world of one (its own
    in-process store: no MASTER_ADDR), with qoc_tpu's names."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh()
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("batch",)
        assert dist.get_backend() == "gloo"
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(tmesh.local_shard(x, mesh), x)
        assert torch.equal(tmesh.gather(x, mesh), x)
        assert tmesh.batch_sharding(mesh) == [
            torch.distributed.tensor.Shard(0)]
        assert tmesh.replicated(mesh) == [torch.distributed.tensor.Replicate()]
        with pytest.raises(ValueError, match="one device each"):
            tmesh.make_mesh(n_devices=2)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def j_shard_run(ranks):
    """qoc_tpu's shard_map step on two virtual devices from the same
    seeds: the stats and pulses of each of the two calls."""
    init, step = j_shard_step(pi_problem(q), JConv.from_dict(SHARD_CONV),
                              _jax_mesh(), steps_per_call=SHARD_STEPS)
    u, opt = init(np.load(ranks.dir / "shard_u0.npy"))
    out = []
    for _ in range(2):
        u, opt, stats = step(u, opt)
        out.append(([float(v) for v in stats], np.asarray(u)))
    return out


@pytest.mark.parametrize("call", [0, 1])
def test_shard_step_matches_qoc_tpu(ranks, j_shard_run, call):
    """8 seeds, 40 steps a call: the pulses within 1e-5, the statistics
    equal on both ranks, the converged count equal to qoc_tpu's and the
    gradient norm within rel 1e-5.  The best and mean losses are held to
    rel 1e-5 or 1e-6 absolute: a loss of 1 - |<psi|tgt>|^2 in float32
    carries an absolute error of a few 1e-8 per operation whatever its
    size, and the best seed's is 4e-4 after the first call and 3e-6 after
    the second, so two float32 programs cannot agree to rel 1e-5 there
    (they differ by 2.4e-7 and 3.6e-7)."""
    want_stats, want_u = j_shard_run[call]
    stats = ranks(f"shard_stats{call}")
    np.testing.assert_array_equal(stats[0], stats[1])
    best, mean, n_conv, g_norm = stats[0]
    np.testing.assert_allclose([best, mean], want_stats[:2], rtol=1e-5,
                               atol=1e-6)
    assert n_conv == want_stats[2]
    np.testing.assert_allclose(g_norm, want_stats[3], rtol=1e-5)
    for u in ranks(f"shard_u{call}"):
        np.testing.assert_allclose(u, want_u, atol=1e-5)
    np.testing.assert_array_equal(ranks("shard_local_seeds"),
                                  [[SHARD_SEEDS // RANKS]] * RANKS)


def test_shard_step_best_falls(ranks):
    """tests/test_distributed.py's bar: the best loss is below 0.5 after
    two calls, and falls from the first."""
    first, second = ranks("shard_stats0")[0], ranks("shard_stats1")[0]
    assert second[0] < first[0] and second[0] < 0.5
    assert np.all(np.isfinite(second))


@pytest.fixture(scope="module")
def j_cols_run(ranks):
    p, extra = leakage_problem(q)
    run = j_cols_runner(p, JConv.from_dict(COLS_CONV), _jax_mesh(),
                        reg_coeffs=COLS_RC, extra_channel_mats=extra)
    u, fids, regs = run(np.load(ranks.dir / "cols_u0.npy"), COLS_ITERS,
                        extra_weights=np.load(ranks.dir / "cols_ew.npy"))
    return dict(u=np.asarray(u), fids=np.asarray(fids),
                regs=np.asarray(regs))


@pytest.mark.parametrize("field,atol", [("u", 1e-5), ("fids", 1e-6),
                                        ("regs", 1e-6)])
def test_sharded_cols_runner_matches_qoc_tpu(ranks, j_cols_run, field, atol):
    """tests/test_xla_batch.py:352-380's set-up (detuning channel and a
    forbidden level), 3 iterations: every rank returns qoc_tpu's global
    u' within 1e-5 and its losses and reg_losses within 1e-6."""
    for got in ranks("cols_" + field):
        np.testing.assert_allclose(got, j_cols_run[field], atol=atol)


def test_sharded_cols_runner_on_a_mesh_of_one_agrees_with_two_ranks(ranks):
    """On this process's world of one, the runner gives the two ranks'
    global result within 1e-7: the per-seed arithmetic is the same, only
    the column products are 8 columns wide instead of 4."""
    import torch.distributed as dist

    p, extra = leakage_problem(qt)
    try:
        run = make_xla_cols_sharded_runner(
            p, TConv.from_dict(COLS_CONV), tmesh.make_mesh(),
            reg_coeffs=COLS_RC, extra_channel_mats=extra, device="cpu")
        u, fids, regs = run(np.load(ranks.dir / "cols_u0.npy"), COLS_ITERS,
                            extra_weights=np.load(ranks.dir / "cols_ew.npy"))
    finally:
        dist.destroy_process_group()
    for name, got in (("u", u), ("fids", fids), ("regs", regs)):
        np.testing.assert_allclose(got.numpy(), ranks("cols_" + name)[0],
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("build", [
    lambda conv, mesh: make_shard_map_step(pi_problem(qt), conv, mesh),
    lambda conv, mesh: make_xla_cols_sharded_runner(pi_problem(qt), conv,
                                                    mesh)],
    ids=["shard_step", "cols_runner"])
def test_device_none_is_the_card(build, monkeypatch):
    """The new entry points default to the card, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None runs on the CUDA"):
        build(TConv.from_dict({}), None)
