"""Scaling evidence for qoc_tpu_torch's seed-sharded batch layer, and the
multi-rank dry run of its four distribution mechanisms: the counterpart of
tools/scaling_evidence.py and of ``dryrun_multichip`` in
__graft_entry__.py.

The port's mesh is one process per device (``parallel.mesh``: a 1-D
``DeviceMesh`` over the ranks of a process group).  The argument for
scaling over devices is assembled from what one host can measure:

1. **Zero collectives in the hot loop** (``collectives_per_segment``).
   Eager torch has no lowered program to search, so every call into
   ``torch.distributed``'s collectives (all_reduce, all_gather,
   all_gather_into_tensor, broadcast, reduce_scatter[_tensor],
   all_to_all[_single]) is counted while a segment of n = 1 and of n = 5
   iterations runs, through ``make_mega_batched_runner(mesh=)`` (kernel 6
   on the card, its plain version on the CPU; the pi pulse at T = 64, 128
   seeds a rank) and ``cols_batch.make_xla_cols_sharded_runner`` (the
   dim-200 multimode cavity at T = 200, 2 seeds a rank).  The difference
   is the hot loop's count and must be 0; the count at n = 1 is the
   gathers at the ends of a call.
2. **Weak-scaling identity** (``weak_scaling_identity``): at D ranks, D
   in {1, 2, 4, 8}, the same 128 x max_ranks seeds (numpy, from a seed)
   through 5 throughput iterations of ``make_mega_batched_runner`` give
   per-seed losses equal to D = 1's bit for bit.
3. **The serial cost per segment** (``dispatch_overhead``, on the card):
   one launch of kernel 6 and the fetch of its [S] losses, separated from
   the iterations by two segment lengths of the same shape, beside the
   1024-seed, T = 1000 iteration time that bench_torch.py's
   ``batched_1024seed`` window measures in the same call.  The efficiency
   at update_step 100 is 100 t_iter / (100 t_iter + dispatch).  One
   segment is split on the host's clock (``dispatch_split``) and traced
   with torch.profiler (``segment_trace``).
4. **The dry run** (``dryrun_multichip``, __graft_entry__.py:44-132 step
   for step): the flagship leakage problem through the batch layer's
   "xla" backend with ``mesh=``, then on the pi pulse (T = 8, 2 seeds a
   rank) ``make_shard_map_step``'s best and mean loss against the xla
   losses (atol 1e-5), and the mega-batched runner and the sharded
   ``xla-cols`` runner against them (atol 5e-5).

Ranks started here are processes over gloo (``--device cpu``: on the
CPU; else every rank on the one card, whose collectives ride host
tensors).  Under ``torchrun`` (WORLD_SIZE set) this process is one rank of
the launcher's group (NCCL, one card a rank) and runs ``--dryrun`` there.
A world of one (``--collectives 1``) is this process alone (NCCL on the
card).  It prints one JSON report, with the card's name and power limit
and, for each part, the kernel launches it made (``launches``: this
process's, or rank 0's).  It exits 1, after the report, when a claim
fails (``failed_claims``: a collective in a hot loop, or losses that
differ from one rank's); the dry run raises at its first disagreement.
Without a card and without ``--device cpu`` it exits 2.

Usage:  python tools/torch_scaling_evidence.py [--device cpu]
            [--collectives N] [--weak N] [--dispatch] [--dryrun N]
        (no mode given: --collectives 2 --weak 8)
        torchrun [--standalone] --nproc-per-node N \\
            tools/torch_scaling_evidence.py --dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import bench_torch  # noqa: E402
import qoc_tpu_torch as q  # noqa: E402
from qoc_tpu_torch.interop import entry_device  # noqa: E402
from qoc_tpu_torch.models.system import ControlProblem  # noqa: E402
from qoc_tpu_torch.ops import _cuda  # noqa: E402
from qoc_tpu_torch.optim.convergence import ConvergenceSettings  # noqa: E402
from qoc_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from qoc_tpu_torch.parallel.batch import make_batched_runner  # noqa: E402
from qoc_tpu_torch.parallel.cols_batch import (  # noqa: E402
    make_xla_cols_sharded_runner)
from qoc_tpu_torch.parallel.mega_batch import (  # noqa: E402
    make_mega_batched_runner)
from qoc_tpu_torch.parallel.shard import make_shard_map_step  # noqa: E402
from qoc_tpu_torch.utils.profiling import card, trace  # noqa: E402

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "broadcast", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single")
SEEDS_PER_RANK = 128          # the mega runner's seeds a rank
COLS_SEEDS_PER_RANK = 2       # the dim-200 xla-cols runner's
WEAK_ITERATIONS = 5
WEAK_SIZES = (1, 2, 4, 8)
DRYRUN_SEEDS_PER_RANK = 2
# seconds for the ranks of one run to finish; a run that takes longer fails
RANK_TIMEOUT = 900


def _problem(steps=64):
    """The 2-level pi pulse (scaling_evidence.py:48-56)."""
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 2.0, steps,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0)


def _conv(update_step=10):
    """No convergence: every seed steps every iteration."""
    return ConvergenceSettings.from_dict(
        {"rate": 0.01, "update_step": update_step,
         "max_iterations": 10 ** 6, "conv_target": -1.0})


def _flagship_problem(steps=100, levels=5):
    """The transmon qudit X gate with leakage levels (BASELINE config 3's
    system, __graft_entry__.py:6-20)."""
    a = q.annihilate(levels)
    H0 = 2 * np.pi * (-0.2) / 2 * (a.conj().T @ a.conj().T @ a @ a)
    X = q.transmon_gate(q.SIGMA_X, levels)
    return ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], X, 6.0,
        steps, [0, 1], maxA=[2.0, 2.0], seed=0)


def seeds(problem, n_seeds: int, seed: int) -> np.ndarray:
    """Initial pulses [S, K, T] made with numpy from ``seed``, stddev
    1/sqrt(steps) as ``parallel.batch.init_seeds`` draws them."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n_seeds, problem.ops_len, problem.steps))
    return (u / np.sqrt(problem.steps)).astype(np.float32)


@contextlib.contextmanager
def counting_collectives():
    """Count the calls into ``torch.distributed``'s collectives inside the
    block (under both of its names, ``torch.distributed.X`` and
    ``distributed_c10d.X``).  Yields the counts by name."""
    c10d = dist.distributed_c10d
    counts = dict.fromkeys(COLLECTIVES, 0)
    saved = [(mod, name, getattr(mod, name))
             for mod in (dist, c10d) for name in COLLECTIVES]

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# what one rank runs (``mesh`` over the ranks of the process group)
# ---------------------------------------------------------------------------


def _segment_counts(segment) -> dict:
    """Collective calls of ``segment(n)`` at n = 1 and n = 5: the hot
    loop's count is their difference, the call's own the count at 1."""
    totals, kinds = {}, set()
    for n in (1, 5):
        with counting_collectives() as counts:
            segment(n)
        totals[n] = sum(counts.values())
        kinds |= {k for k, v in counts.items() if v}
    return {"n1": totals[1], "n5": totals[5],
            "hot_loop": totals[5] - totals[1], "per_call": totals[1],
            "kinds": sorted(kinds)}


def collectives_on_rank(mesh, device) -> dict:
    """``collectives_per_segment``'s counts on this rank."""
    p, conv = _problem(), _conv()
    u0 = seeds(p, SEEDS_PER_RANK * mesh.size(), 0)
    init, run_n, read_u = make_mega_batched_runner(p, conv, mesh=mesh,
                                                   device=device)

    def mega_segment(n):
        st = run_n(init(u0), n)
        tmesh.gather(st.losses, mesh)
        read_u(st)

    p200, _ = bench_torch._dim200_problem()     # the multimode cavity
    conv200 = _conv(update_step=100)
    run = make_xla_cols_sharded_runner(p200, conv200, mesh, device=device)
    u200 = seeds(p200, COLS_SEEDS_PER_RANK * mesh.size(), 0)
    return {"ranks": mesh.size(), "backend": dist.get_backend(),
            "mega_batch": dict(_segment_counts(mega_segment),
                               seeds_per_rank=SEEDS_PER_RANK, steps=p.steps),
            "xla_cols_dim200": dict(
                _segment_counts(lambda n: run(u200, n)),
                seeds_per_rank=COLS_SEEDS_PER_RANK, steps=p200.steps)}


def weak_on_rank(mesh, device, max_ranks: int) -> dict:
    """The 128 x ``max_ranks`` seeds' losses after WEAK_ITERATIONS
    throughput iterations of the mega runner, gathered."""
    p, conv = _problem(), _conv()
    u0 = seeds(p, SEEDS_PER_RANK * max_ranks, 0)
    init, run_n, _ = make_mega_batched_runner(p, conv, mesh=mesh,
                                              throughput=True, device=device)
    t0 = time.perf_counter()
    st = run_n(init(u0), WEAK_ITERATIONS)
    losses = tmesh.gather(st.losses, mesh).cpu().numpy()
    return {"ranks": mesh.size(), "wall_s": time.perf_counter() - t0,
            "losses": losses.tolist()}


def dryrun_on_rank(mesh, device) -> dict:
    """The four mechanisms on this rank (``dryrun_multichip``); rank 0
    prints the ok lines."""
    n = mesh.size()
    n_seeds = DRYRUN_SEEDS_PER_RANK * n
    conv = ConvergenceSettings.from_dict(
        {"rate": 0.01, "update_step": 2, "max_iterations": 1000,
         "conv_target": 1e-10})
    lead = mesh.get_local_rank() == 0

    def ok(line):
        if lead:
            print(line, flush=True)

    def whole(x):
        return tmesh.gather(x, mesh).cpu().numpy()

    # --- mechanism 1: the batch layer's "xla" backend with mesh= ---------
    problem = _flagship_problem(steps=8, levels=3)
    init_state, run_segment = make_batched_runner(
        problem, conv, reg_coeffs={"dwdt": 0.001}, mesh=mesh, backend="xla",
        device=device)
    u = seeds(problem, n_seeds, 0)
    state = run_segment(init_state(torch.as_tensor(u)), 2, None)
    u_global, losses_1 = whole(state.u_base), whole(state.loss)
    if u_global.shape != (n_seeds, problem.ops_len, problem.steps):
        raise AssertionError(f"mechanism 1: u_base {u_global.shape}")
    if not np.all(np.isfinite(losses_1)):
        raise AssertionError(f"mechanism 1: losses {losses_1}")
    ok("dryrun mechanism 1 (batch layer xla + mesh): ok")

    # --- mechanisms 2-4 against the xla losses on the pi pulse ----------
    p2 = _problem(steps=8)
    u0 = seeds(p2, n_seeds, 1)
    init_x, run_x = make_batched_runner(p2, conv, mesh=mesh, backend="xla",
                                        device=device)
    losses_xla = whole(run_x(init_x(torch.as_tensor(u0)), 2, None).loss)

    init_s, step_s = make_shard_map_step(p2, conv, mesh, steps_per_call=2,
                                         device=device)
    u_s, opt_s = init_s(u0)
    _, _, stats = step_s(u_s, opt_s)
    best, mean = float(stats.best_loss), float(stats.mean_loss)
    np.testing.assert_allclose(best, float(losses_xla.min()), atol=1e-5)
    np.testing.assert_allclose(mean, float(losses_xla.mean()), atol=1e-5)
    ok("dryrun mechanism 2 (shard step + all_reduce): ok")

    init_m, run_m, _ = make_mega_batched_runner(p2, conv, mesh=mesh,
                                                device=device)
    losses_mega = whole(run_m(init_m(u0), 2).losses)
    np.testing.assert_allclose(losses_mega, losses_xla, atol=5e-5)
    ok("dryrun mechanism 3 (sharded mega-batch kernel): ok")

    run_c = make_xla_cols_sharded_runner(p2, conv, mesh, device=device)
    _, losses_cols, _ = run_c(u0, 2)
    losses_cols = losses_cols.cpu().numpy()
    np.testing.assert_allclose(losses_cols, losses_xla, atol=5e-5)
    ok("dryrun mechanism 4 (sharded xla-cols runner): ok")
    return {"ranks": n, "backend": dist.get_backend(),
            "mechanism_1_losses": losses_1.tolist(),
            "xla": losses_xla.tolist(), "shard_best": best,
            "shard_mean": mean, "mega": losses_mega.tolist(),
            "cols": losses_cols.tolist()}


RANK_TASKS = {"collectives": collectives_on_rank, "weak": weak_on_rank,
              "dryrun": dryrun_on_rank}


def _with_launches(fn, *args, **kwargs) -> dict:
    """``fn``'s result dict with the kernel launches it made
    (``ops._cuda.LAUNCHES``; none on the CPU) under ``launches``."""
    before = dict(_cuda.LAUNCHES)
    result = fn(*args, **kwargs)
    result["launches"] = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                          if v != before[k]}
    return result


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def run_ranks(task: str, n_ranks: int, device: str, **task_args) -> list:
    """Run ``RANK_TASKS[task]`` on ``n_ranks`` gloo ranks, each a process
    of its own on ``device`` ("cpu", or "cuda": all on the one card);
    returns each rank's result.  ``task_args`` go to the ranks as JSON."""
    if device == "cuda":
        _cuda.build()        # once, before the ranks load it
    with tempfile.TemporaryDirectory(prefix="scaling_evidence_") as tmp:
        spec = os.path.join(tmp, "task.json")
        with open(spec, "w") as f:
            json.dump({"task": task, "device": device, "args": task_args},
                      f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-of", spec,
             "--rank", str(r), "--world", str(n_ranks)], cwd=ROOT)
            for r in range(n_ranks)]
        try:
            codes = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f"{task} on {n_ranks} ranks: exit codes "
                               f"{codes}")
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def _rank_main(spec_path: str, rank: int, world: int) -> int:
    """One rank started by ``run_ranks``: join the gloo group, run the
    task, write the result beside the task's spec."""
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    tmp = os.path.dirname(spec_path)
    device = (torch.device("cpu") if spec["device"] == "cpu"
              else torch.device("cuda", 0))
    tmesh.init_distributed(backend="gloo", world_size=world, rank=rank,
                           init_method="file://" + os.path.join(
                               tmp, "rendezvous"))
    try:
        result = _with_launches(RANK_TASKS[spec["task"]], tmesh.make_mesh(),
                                device, **spec["args"])
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def _world_of_one(task: str, device, **task_args) -> dict:
    """``task`` in this process over a world of one (``make_mesh`` with no
    process group: NCCL on the card, gloo on the CPU)."""
    mesh = tmesh.make_mesh()
    try:
        return _with_launches(RANK_TASKS[task], mesh, device, **task_args)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the measurements
# ---------------------------------------------------------------------------


def collectives_per_segment(n_ranks: int, device) -> dict:
    """Collective calls per segment of both sharded runners at
    ``n_ranks`` (1: a world of one in this process)."""
    device = torch.device(device)
    if n_ranks == 1:
        return _world_of_one("collectives", device)
    per_rank = run_ranks("collectives", n_ranks, device.type)
    if any(r != per_rank[0] for r in per_rank):
        raise AssertionError(f"the ranks counted differently: {per_rank}")
    return per_rank[0]


def weak_scaling_identity(max_ranks: int, device) -> dict:
    """Per-seed losses at D ranks against D = 1's, D in {1, 2, 4, 8} up to
    ``max_ranks``, bit for bit (``max_abs_diff`` reports the gap)."""
    device = torch.device(device)
    ref, sizes = None, []
    for D in WEAK_SIZES:
        if D > max_ranks:
            break
        res = run_ranks("weak", D, device.type, max_ranks=max_ranks)[0]
        losses = np.asarray(res["losses"], dtype=np.float32)
        if ref is None:
            ref = losses
        sizes.append({"ranks": D, "wall_s": res["wall_s"],
                      "losses_identical_to_1rank": bool(
                          np.array_equal(losses, ref)),
                      "max_abs_diff": float(np.max(np.abs(losses - ref))),
                      "launches": res["launches"]})
    return {"seeds": SEEDS_PER_RANK * max_ranks,
            "iterations": WEAK_ITERATIONS, "sizes": sizes}


def dispatch_overhead(device, n1: int = 1, n2: int = 2001,
                      reps: int = 5) -> dict:
    """The serial cost of one segment on the card: kernel 6 at 1024 seeds,
    T = 64, throughput mode; dispatch = t(n1) - n1 (t(n2) - t(n1)) / (n2 -
    n1), each time the best of ``reps`` runs ending with the [S] losses on
    the host.  t_iter: bench_torch.py's ``batched_1024seed`` window (1024
    pi seeds, T = 1000) measured now; the efficiency at update_step 100;
    one n1 segment split on the host's clock and traced."""
    device = torch.device(device)
    p, conv = _problem(steps=64), _conv()
    S = 1024
    init_state, run_n, _ = make_mega_batched_runner(
        p, conv, throughput=True, device=device)
    st0 = init_state(seeds(p, S, 0))
    for n in (n1, n2):
        run_n(st0, n).losses.cpu()               # build and warm

    def timed(n):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run_n(st0, n).losses.cpu().numpy()
            walls.append(time.perf_counter() - t0)
        return min(walls)

    t1, t2 = timed(n1), timed(n2)
    per_iter = (t2 - t1) / (n2 - n1)
    dispatch = t1 - n1 * per_iter
    split = dispatch_split(run_n, st0, n1, reps)
    traced = segment_trace(run_n, st0, n1)
    window = bench_torch.batched_iters_per_sec_mega(device, n_seeds=S)
    t_iter = S / window["median"]
    return {"seeds": S, "steps": p.steps, "n1": n1, "n2": n2,
            "t_n1_s": t1, "t_n2_s": t2, "segment_dispatch_s": dispatch,
            "per_iteration_s_steps64": per_iter,
            "split_n1": split, "trace_n1": traced,
            "t_iter_s_1024seed_steps1000": t_iter,
            "batched_1024seed_seed_iters_per_s": window["median"],
            "efficiency_update_step_100_pct":
                100.0 * 100 * t_iter / (100 * t_iter + dispatch)}


def dispatch_split(run_n, st0, n: int, reps: int) -> dict:
    """One segment of ``n`` iterations split on the host's clock, the best
    of ``reps`` by its whole: the runner's work before the launch (the
    copies of u, m, v and the counters, the extra weights), the launch
    (kernel 6's wrapper: operand checks and the launch call, and two CUDA
    event records), the runner's work after it (the slices of the stats),
    and the fetch of the [S] losses (which waits for the kernel).  Beside
    them the kernel's time on the card, from the two events."""
    real = _cuda.mega_batch_segment
    marks = {}

    def marked(*args, **kwargs):
        marks["enter"] = time.perf_counter()
        marks["start"].record()
        out = real(*args, **kwargs)
        marks["end"].record()
        marks["exit"] = time.perf_counter()
        return out

    best = None
    _cuda.mega_batch_segment = marked
    try:
        for _ in range(reps):
            marks.update(start=torch.cuda.Event(enable_timing=True),
                         end=torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            st = run_n(st0, n)
            t1 = time.perf_counter()
            st.losses.cpu().numpy()
            t2 = time.perf_counter()
            split = {"total_s": t2 - t0,
                     "before_launch_s": marks["enter"] - t0,
                     "launch_s": marks["exit"] - marks["enter"],
                     "after_launch_s": t1 - marks["exit"],
                     "fetch_s": t2 - t1,
                     "kernel_on_card_s":
                         marks["start"].elapsed_time(marks["end"]) / 1e3}
            if best is None or split["total_s"] < best["total_s"]:
                best = split
    finally:
        _cuda.mega_batch_segment = real
    return best


def segment_trace(run_n, st0, n: int) -> dict:
    """One segment of ``n`` iterations and its fetch under torch.profiler:
    what ran on the card (kernels, copies, fills: name and microseconds)
    and the CUDA runtime calls on the host (count and microseconds by
    name)."""
    with tempfile.TemporaryDirectory(prefix="dispatch_trace_") as tmp:
        with trace(tmp):
            run_n(st0, n).losses.cpu().numpy()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    on_card = [{"name": e["name"][:60], "cat": e["cat"], "us": e["dur"]}
               for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    runtime: dict = {}
    for e in events:
        if e.get("cat") == "cuda_runtime":
            calls, us = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (calls + 1, us + e.get("dur", 0.0))
    return {"on_card": on_card,
            "runtime": {k: {"calls": c, "us": us}
                        for k, (c, us) in sorted(runtime.items())}}


def dryrun_multichip(n_ranks: int, device) -> dict:
    """The four mechanisms on ``n_ranks`` gloo ranks (or, under
    ``torchrun``, on the launcher's ranks: see ``main``)."""
    return run_ranks("dryrun", n_ranks, torch.device(device).type)[0]


def failed_claims(report: dict) -> list:
    """What the report's collective counts and weak-scaling sizes show to
    fail: a collective in a runner's hot loop, or per-seed losses at D
    ranks that differ from one rank's."""
    failed = []
    for runner in ("mega_batch", "xla_cols_dim200"):
        c = report.get("collectives", {}).get(runner)
        if c is not None and c["hot_loop"] != 0:
            failed.append(f"{runner}: {c['hot_loop']} collective calls in "
                          f"the hot loop")
    for size in report.get("weak_scaling", {}).get("sizes", []):
        if not size["losses_identical_to_1rank"]:
            failed.append(f"weak scaling: the losses at {size['ranks']} "
                          f"ranks differ from one rank's by up to "
                          f"{size['max_abs_diff']:.3e}")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cpu runs the plain versions (default: the card)")
    ap.add_argument("--collectives", type=int, default=None, metavar="N",
                    help="count collectives per segment on N ranks")
    ap.add_argument("--weak", type=int, default=None, metavar="N",
                    help="weak-scaling identity up to N ranks")
    ap.add_argument("--dispatch", action="store_true",
                    help="the serial cost per segment (on the card)")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="the four mechanisms on N ranks")
    ap.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        return _rank_main(args.rank_of, args.rank, args.world)
    try:
        device = entry_device(args.device)
    except RuntimeError as e:
        print(f"{ap.prog}: {e}", file=sys.stderr)
        return 2
    if args.dispatch and device.type != "cuda":
        ap.error("--dispatch measures the card")
    if "WORLD_SIZE" in os.environ:
        # one rank of a torchrun launch: the dry run over its ranks
        if args.dryrun != int(os.environ["WORLD_SIZE"]):
            ap.error("under torchrun: --dryrun N with N the world size")
        tmesh.init_distributed(**({} if device.type == "cuda"
                                  else {"backend": "gloo"}))
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = tmesh.make_mesh()
        lead = mesh.get_local_rank() == 0
        try:
            result = _with_launches(dryrun_on_rank, mesh, device)
        finally:
            dist.destroy_process_group()
        if lead:
            print(json.dumps({"card": card(device), "dryrun": result}),
                  flush=True)
        return 0
    if not (args.collectives or args.weak or args.dispatch or args.dryrun):
        args.collectives, args.weak = 2, 8
    report = {"card": card(device)}
    if args.dispatch:
        report["dispatch"] = _with_launches(dispatch_overhead, device)
    if args.collectives:
        report["collectives"] = collectives_per_segment(args.collectives,
                                                        device)
    if args.weak:
        report["weak_scaling"] = weak_scaling_identity(args.weak, device)
    if args.dryrun:
        report["dryrun"] = dryrun_multichip(args.dryrun, device)
    print(json.dumps(report), flush=True)
    failed = failed_claims(report)
    for line in failed:
        print(f"{ap.prog}: {line}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
