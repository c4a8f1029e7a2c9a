"""The four-rank path on the CPU: a small cell over four gloo ranks
(``smallmm.sweep_x4``: two seeds a rank), each run under a time limit of
its own.  The window closes on every rank and nothing hangs; the
seed-iterations count every shard; a fault on one rank's shard alone,
half of every shard left out, or the exchange between ranks left out,
makes ``correct`` false; a rank
that fails, or that holds a module of JAX or of the JAX package once the
window has closed, ends the run with no result and leaves no process
behind."""

import re
import shutil
import time
from pathlib import Path

import pytest

from copies import make_copy, plant, run_copy

CELL = "smallmm.sweep_x4"
LIMIT_S = 240

# on rank 3 alone: the segment hands back the pulses it was given
STILL_RANK3 = """
import os
import qoc_tpu_torch.parallel.batch as _B
_sharded = _B._sharded_runner
def _still(init_state, run_segment, mesh):
    def seg(state, stop_at, mats_b):
        out = run_segment(state, stop_at, mats_b)
        if os.environ.get("LOCAL_RANK") == "3":
            out = out._replace(u_base=state.u_base)
        return out
    return _sharded(init_state, seg, mesh)
_B._sharded_runner = _still
"""
# on every rank: the second half of its shard is left out of each step
HALF = """
import torch
import qoc_tpu_torch.parallel.batch as _B
_sharded = _B._sharded_runner
def _half(init_state, run_segment, mesh):
    def seg(state, stop_at, mats_b):
        out = run_segment(state, stop_at, mats_b)
        h = state.u_base.shape[0] // 2
        return out._replace(u_base=torch.cat([out.u_base[:h],
                                              state.u_base[h:]]))
    return _sharded(init_state, seg, mesh)
_B._sharded_runner = _half
"""
# on rank 3 alone: the window's answers leave its card altered
ALTER_RANK3 = """
import os
import qoc_tpu_torch.parallel.batch as _B
_batched, _gather = _B.batched_grape_adam, _B.gather
_window = [False]
def _calls(*a, **k):
    _window[0] = k["convergence"]["max_iterations"] > 3
    return _batched(*a, **k)
def _altered(x, mesh):
    if _window[0] and os.environ.get("LOCAL_RANK") == "3" and x.dim() == 3:
        x = x.clone()
        x[:, 0, x.shape[2] // 2] += 0.05
    return _gather(x, mesh)
_B.batched_grape_adam, _B.gather = _calls, _altered
"""
# on every rank: the gathers leave out the exchange (each rank's shard
# stands for every shard)
NO_EXCHANGE = """
import torch
import qoc_tpu_torch.parallel.batch as _B
_B.gather = lambda x, mesh: torch.cat([x] * mesh.size())
"""
# rank k fails in the window
RAISE_RANK = """
import os
import qoc_tpu_torch.parallel.batch as _B
_batched = _B.batched_grape_adam
def _fails(*a, **k):
    if (os.environ.get("LOCAL_RANK") == "{rank}"
            and k["convergence"]["max_iterations"] > 3):
        raise RuntimeError("planted failure on rank {rank}")
    return _batched(*a, **k)
_B.batched_grape_adam = _fails
"""
# on rank 2 alone: the JAX package is loaded (a stand-in module of its
# name)
JAX_RANK2 = """
import os, sys, types
if os.environ.get("LOCAL_RANK") == "2":
    sys.modules["qoc_tpu"] = types.ModuleType("qoc_tpu")
"""


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("ranks"))


def _copy(base: Path, dst: Path, code: str) -> Path:
    shutil.copytree(base, dst)
    if code:
        plant(dst, code)
    return dst


def _left_behind(root: Path) -> list:
    """Processes still running the copy's run.py."""
    out = []
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            cmd = (proc / "cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        if str(root / "benchmark" / "run.py").encode() in cmd:
            out.append(proc.name)
    return out


def test_the_window_closes_on_every_rank(base, tmp_path):
    root = _copy(base, tmp_path / "sound", "")
    t0 = time.monotonic()
    rc, out, err = run_copy(root, CELL, seconds=4.0, timeout=LIMIT_S)
    assert rc == 0, err[-4000:]
    assert time.monotonic() - t0 < LIMIT_S
    assert out["correct"] is True, out["checks"]
    assert out["device"]["count"] == 4
    assert set(out["metrics"]) == {"seed_iters_per_s.x4", "setup_s"}
    assert "answer_gap" in out["checks"]
    # every rank left the same call at the same boundary
    windows = re.findall(r"window: [\d.]+ s, (\d+) calls, 0 whole solves, "
                         r"(\d+) iterations, (\d+) seed-iterations", err)
    assert len(windows) == 4 and len(set(windows)) == 1, windows
    # the seed-iterations count all four shards: four times one rank's
    shards = re.search(r"seed-iterations of each shard \[([\d, ]+)\]", err)
    shards = [int(x) for x in shards.group(1).split(",")]
    total = int(windows[0][2])
    assert len(shards) == 4 and total == 4 * shards[3] == sum(shards)
    # no seed freezes in the window (a target of 0): 8 seeds an iteration
    assert total == 8 * int(windows[0][1]) > 0
    assert not _left_behind(root)


FAULTS = {"unchanged_on_rank3": STILL_RANK3, "half_of_each_shard": HALF,
          "answers_altered_on_rank3": ALTER_RANK3,
          "no_exchange": NO_EXCHANGE}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_on_one_rank_is_not_correct(base, tmp_path, fault):
    root = _copy(base, tmp_path / fault, FAULTS[fault])
    rc, out, err = run_copy(root, CELL, seconds=4.0, timeout=LIMIT_S)
    assert rc == 0, err[-4000:]
    assert out["correct"] is False, out["checks"]
    failed = {n for n, c in out["checks"].items() if c["value"] > c["limit"]}
    if fault == "answers_altered_on_rank3":
        assert failed == {"answer_gap"}, out["checks"]
    assert not _left_behind(root)


@pytest.mark.parametrize("rank", [2, 0])
def test_a_rank_that_fails_ends_the_run(base, tmp_path, rank):
    root = _copy(base, tmp_path / f"fails{rank}",
                 RAISE_RANK.replace("{rank}", str(rank)))
    t0 = time.monotonic()
    rc, out, err = run_copy(root, CELL, seconds=120.0, timeout=LIMIT_S)
    assert rc != 0 and out is None
    assert f"planted failure on rank {rank}" in err
    # the run ends long before its window of 120 s would have closed
    assert time.monotonic() - t0 < 60.0
    assert not _left_behind(root)


def test_the_jax_package_on_one_rank_gives_no_result(base, tmp_path):
    root = _copy(base, tmp_path / "jax2", JAX_RANK2)
    rc, out, err = run_copy(root, CELL, seconds=4.0, timeout=LIMIT_S)
    assert rc != 0 and out is None, err[-4000:]
    assert "modules of JAX or of the JAX package are loaded: rank 2: " \
        "qoc_tpu" in err
    assert not _left_behind(root)
