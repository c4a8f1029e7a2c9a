"""tools/torch_scaling_evidence.py on the CPU (gloo ranks, the plain
versions): no collective in the hot loop of the mega-batched runner and of
the sharded ``xla-cols`` runner on two ranks, weak-scaling identity at 1,
2 and 4 ranks, the dry run's four ok lines on two ranks (started by the
tool, and under torchrun), and its mechanisms 2-4 against qoc_tpu's
(``dryrun_multichip``'s calls on two of the conftest's virtual CPU
devices, the same initial pulses) at qoc_tpu's tolerances; the tool exits
1 on a failed claim.

The tool runs once per module as a command (``--device cpu --collectives
2 --weak 4 --dryrun 2``; its ranks are processes of their own) and the
tests read its report."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qoc_tpu as jq
from qoc_tpu.models.system import ControlProblem as JProblem
from qoc_tpu.optim.convergence import ConvergenceSettings as JConv
from qoc_tpu.parallel.batch import make_batched_runner as j_batched_runner
from qoc_tpu.parallel.mesh import batch_sharding, make_mesh as j_make_mesh
from qoc_tpu.parallel.pallas_mega_batch import (
    make_mega_batched_runner as j_mega_runner)
from qoc_tpu.parallel.shard import make_shard_map_step as j_shard_step
from qoc_tpu.parallel.xla_batch import (
    make_xla_cols_sharded_runner as j_cols_runner)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_scaling_evidence.py")
ARGV = ["--device", "cpu", "--collectives", "2", "--weak", "4",
        "--dryrun", "2"]
# seconds for the whole report; a run that takes longer fails
TOOL_TIMEOUT = 400


def _load():
    spec = importlib.util.spec_from_file_location("torch_scaling_evidence",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load()


@pytest.fixture(scope="module")
def run():
    """(stdout lines, the JSON report) of one run of the tool."""
    out = subprocess.run([sys.executable, TOOL, *ARGV], cwd=REPO,
                         capture_output=True, text=True,
                         timeout=TOOL_TIMEOUT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    return lines, json.loads(lines[-1])


@pytest.mark.parametrize("runner", ["mega_batch", "xla_cols_dim200"])
def test_no_collective_in_the_hot_loop(run, runner):
    """The count at n = 5 equals the count at n = 1: only the gathers at
    the ends of a call, none per iteration."""
    rep = run[1]["collectives"]
    assert rep["ranks"] == 2 and rep["backend"] == "gloo"
    c = rep[runner]
    assert c["hot_loop"] == 0, c
    assert c["n1"] == c["n5"] == c["per_call"] >= 1, c
    assert c["kinds"] == ["all_gather"], c


def test_weak_scaling_identity(run):
    """The same 512 seeds at 1, 2 and 4 ranks: per-seed losses equal bit
    for bit."""
    rep = run[1]["weak_scaling"]
    assert rep["seeds"] == 4 * tool.SEEDS_PER_RANK
    assert [s["ranks"] for s in rep["sizes"]] == [1, 2, 4]
    for s in rep["sizes"]:
        assert s["losses_identical_to_1rank"], s
        assert s["max_abs_diff"] == 0.0, s


def test_dryrun_prints_the_four_ok_lines(run):
    lines, rep = run
    oks = [line for line in lines if line.startswith("dryrun mechanism")]
    assert [line.split()[2] for line in oks] == ["1", "2", "3", "4"]
    assert all(line.endswith(": ok") for line in oks)
    d = rep["dryrun"]
    assert d["ranks"] == 2 and len(d["xla"]) == 2 * tool.DRYRUN_SEEDS_PER_RANK
    assert np.all(np.isfinite(d["mechanism_1_losses"]))


def _qoc_tpu_dryrun(u0):
    """Mechanisms 2-4 of qoc_tpu's ``dryrun_multichip`` on two virtual
    devices (__graft_entry__.py:100-132), from ``u0``."""
    mesh = j_make_mesh(n_devices=2)
    conv = JConv.from_dict({"rate": 0.01, "update_step": 2,
                            "max_iterations": 1000, "conv_target": 1e-10})
    p2 = JProblem.build(
        np.zeros((2, 2), dtype=complex), [jq.SIGMA_X, jq.SIGMA_Y],
        ["x", "y"], [np.array([0, 1], dtype=complex)], 2.0, 8,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0)
    init_x, run_x = j_batched_runner(p2, conv, mesh=mesh, backend="xla")
    sx = run_x(init_x(jax.device_put(jnp.asarray(u0),
                                     batch_sharding(mesh))),
               jnp.asarray(2, dtype=jnp.int32), None)
    init_s, step_s = j_shard_step(p2, conv, mesh, steps_per_call=2)
    _, _, stats = step_s(*init_s(u0))
    init_m, run_m, _ = j_mega_runner(p2, conv, mesh=mesh)
    _, losses_cols, _ = j_cols_runner(p2, conv, mesh)(u0, 2)
    return {"xla": np.asarray(sx.loss),
            "shard_best": float(stats.best_loss),
            "shard_mean": float(stats.mean_loss),
            "mega": np.asarray(run_m(init_m(u0), 2).losses),
            "cols": np.asarray(losses_cols)}


def test_dryrun_matches_qoc_tpu(run):
    """The port's mechanisms 2-4 on two gloo ranks against qoc_tpu's on
    two virtual devices, from the same initial pulses, at qoc_tpu's own
    tolerances (1e-5 on the shard step's statistics, 5e-5 on the
    losses)."""
    d = run[1]["dryrun"]
    u0 = tool.seeds(tool._problem(steps=8),
                    2 * tool.DRYRUN_SEEDS_PER_RANK, 1)
    want = _qoc_tpu_dryrun(u0)
    np.testing.assert_allclose(d["shard_best"], want["shard_best"],
                               atol=1e-5)
    np.testing.assert_allclose(d["shard_mean"], want["shard_mean"],
                               atol=1e-5)
    for k in ("xla", "mega", "cols"):
        np.testing.assert_allclose(d[k], want[k], atol=5e-5, err_msg=k)


def test_dryrun_under_torchrun(run):
    """``torchrun --nproc-per-node 2 ... --dryrun 2``: this process's ranks
    are the launcher's (gloo on the CPU); the same four ok lines and the
    same losses as the ranks the tool starts itself."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", TOOL, "--dryrun", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=TOOL_TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert sum(line.startswith("dryrun mechanism") and line.endswith(": ok")
               for line in lines) == 4
    got, want = json.loads(lines[-1])["dryrun"], run[1]["dryrun"]
    for k in ("mechanism_1_losses", "xla", "shard_best", "shard_mean",
              "mega", "cols"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_counting_collectives_counts_each_call():
    """The counter sees calls under both names and restores them."""
    dist = torch.distributed
    originals = (dist.all_reduce, dist.distributed_c10d.all_gather)
    from qoc_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh()
    try:
        with tool.counting_collectives() as counts:
            tmesh.all_reduce(torch.ones(3), mesh)
            tmesh.gather(torch.ones(2, 3), mesh)
            dist.distributed_c10d.all_reduce(torch.ones(1))
    finally:
        dist.destroy_process_group()
    assert counts["all_reduce"] == 2 and counts["all_gather"] == 1
    assert sum(counts.values()) == 3
    assert (dist.all_reduce, dist.distributed_c10d.all_gather) == originals


def test_tool_needs_the_card(monkeypatch, capsys):
    """Without a card and without ``--device cpu``: exit 2, no report;
    ``--dispatch`` measures the card only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit) as e:
        tool.main(["--device", "cpu", "--dispatch"])
    assert e.value.code == 2


def _report(hot_loop=0, weak_diff=0.0):
    sizes = [{"ranks": D, "losses_identical_to_1rank": D == 1 or not weak_diff,
              "max_abs_diff": 0.0 if D == 1 else weak_diff}
             for D in (1, 2)]
    return {"collectives": {k: {"hot_loop": hot_loop}
                            for k in ("mega_batch", "xla_cols_dim200")},
            "weak_scaling": {"sizes": sizes}}


@pytest.mark.parametrize("case,want", [
    (dict(), []),
    (dict(hot_loop=1), ["mega_batch: 1 collective calls in the hot loop",
                        "xla_cols_dim200: 1 collective calls in the hot "
                        "loop"]),
    (dict(weak_diff=6e-8), ["weak scaling: the losses at 2 ranks differ "
                            "from one rank's by up to 6.000e-08"])])
def test_failed_claims(case, want):
    """A collective in a hot loop and losses that differ from one rank's
    are each a failed claim; a clean report has none."""
    assert tool.failed_claims(_report(**case)) == want


def test_tool_exits_1_when_a_claim_fails(monkeypatch, capsys):
    """The report is printed all the same, then the tool exits 1."""
    monkeypatch.setattr(tool, "weak_scaling_identity",
                        lambda n, device: _report(weak_diff=1e-7)[
                            "weak_scaling"])
    assert tool.main(["--device", "cpu", "--weak", "2"]) == 1
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["weak_scaling"]
    assert "differ from one rank's" in err
