"""Run one cell of the benchmark of qoc_tpu_torch once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by
name from ``BENCHMARK.json`` (``benchmark/harness.py``).  A run: set-up
(the card, the kernels, the configuration, one warm-up call at the
cell's shapes whose readings the check compares), the measured window
(``--trace 0``: the end-to-end metrics on the host's clock; ``--trace
1``: a shorter window under ``torch.profiler`` for the per-layer
metrics), then, with the program's state freed, the plain reference on
the card decides ``correct``.  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.

A cell on more than one card runs one rank a card (``benchmark/ranks.py``):
this process hands itself to PyTorch's launcher, which runs the same
command once a card; the window is rank 0's, closed at a boundary that
every rank leaves together; with ``--trace 1`` every rank runs under its
own profiler and sends rank 0 a summary of its trace; rank 0 alone
prints the result and runs the reference.  ``setup_s`` runs from the
launcher's start to rank 0's window, after every rank's set-up.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and
1 with no result when a module of JAX or of the JAX package was loaded
in any rank; on more than one card, a rank that fails ends every rank,
and the launcher exits with another code than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the program's kernel caches stay inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", ".triton_cache"),
                 ("TORCH_EXTENSIONS_DIR", ".torch_extensions")):
    os.environ.setdefault(var, str(ROOT / sub))
os.environ.setdefault("USE_FLAX", "0")

# a cell on more than one card starts its ranks before this process
# imports torch, the harness and the program (``main``)
from benchmark import ranks  # noqa: E402

# a rank counts its set-up from the launcher's start
T_START = (ranks.told() or {}).get("t_start", T_START)


def log(*parts) -> None:
    # one write a line: the ranks of a launch share standard error
    sys.stderr.write(" ".join(map(str, parts)) + "\n")
    sys.stderr.flush()


def work_sizes(cell, swept: bool) -> dict:
    """The problem's sizes for ``benchmark/work``, from the system's
    matrices and the upstream Taylor pre-pass; ``swept``: the extra
    operators are channels of the run."""
    from benchmark.work import taylor

    s = cell.system
    N = len(s["H0"])
    dt = s["total_time"] / s["steps"]
    terms, squarings = taylor.taylor_terms(s["H0"], s["Hops"], s["maxA"], dt,
                                           s["steps"], s["state_transfer"])
    return {"M": 2 * N, "K": len(s["Hops"]), "E": len(s.get("extra_ops") or [])
            if swept else 0,
            "T": int(s["steps"]), "V": len(s["states"]), "terms": terms,
            "squarings": squarings, "reg_coeffs": s["reg_coeffs"]}


def peaks(kind: str) -> dict:
    from benchmark import harness

    table = json.loads((harness.HERE / "peaks.json").read_text())
    if kind not in table["cards"]:
        log(f"peaks: no entry for {kind!r}; using {table['default']!r}")
        kind = table["default"]
    return table["cards"][kind]


def main(argv=None, device=None) -> int:
    """Run the cell.  ``device`` is for the harness's own tests, which
    drive a run on the CPU; the command line always takes the card (a
    rank of a launch takes the card, or the CPU, the launcher names)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    kind = "cuda" if device is None else str(device).split(":")[0]
    got = ranks.launch(args.workload, str(Path(__file__).resolve()), argv,
                       kind, T_START)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if got is not None:
        device = ranks.device_of(got)
    elif device is None:
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < chips):
        log(f"run: the cell {cell.name} needs {chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    rk = ranks.start(device)
    if chips > 1:
        log(f"ranks: rank {rk.rank} of {chips} joined at "
            f"{time.perf_counter() - T_START:.3f} s")
    return run(args, cell, device, rk)


def run(args, cell, device, rk) -> int:
    import torch

    from benchmark import check as chk
    from benchmark import harness, trace
    from benchmark.reference import grape as ref
    from benchmark.work import column_batch

    on_card = device.type == "cuda"
    chips = rk.world
    if rk.lead:
        for line in harness.card_lines(device):
            log(line)

    from qoc_tpu_torch.ops import _cuda

    gen = cell.generator(device, args.seed, rk)
    swept = getattr(gen, "extra", None) is not None
    t_prep = time.perf_counter()
    gen.prepare()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rk.barrier()
    setup_s = time.perf_counter() - T_START
    log(f"setup: {setup_s:.3f} s (warm-up and check call "
        f"{time.perf_counter() - t_prep:.3f} s)")

    launches0 = dict(_cuda.LAUNCHES)
    tracer = None
    seconds = args.seconds
    if args.trace:
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
        tracer = trace.Tracer()
        tracer.start()
    with torch.profiler.record_function("bench.window"):
        rec = gen.window(seconds)
        if on_card:
            torch.cuda.synchronize(device)
    if tracer is not None:
        tracer.stop()
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    launches = {k: v - launches0[k] for k, v in _cuda.LAUNCHES.items()
                if v != launches0[k]}
    if rk.lead:
        for line in gen.sink.routes:
            log("route:", line)
    log(f"window: {rec['window_s']:.3f} s, {rec['attempted']} calls, "
        f"{len(rec['solve_walls'])} whole solves, {rec['iterations']} "
        f"iterations, {rec['seed_iterations']} seed-iterations; kernel "
        f"launches {json.dumps(launches)}; program lines "
        f"{gen.sink.lines}")

    # what each rank read of its own card and trace, in rank order
    mine = {"memory_peak_bytes": int(mem_peak),
            "shard_seed_iterations": rec.get("shard_seed_iterations"),
            "banned": harness.banned_modules()}
    events = lo = hi = None
    if tracer is not None:
        events = tracer.events()
        del tracer
        win = trace.spans(events, "bench.window")
        lo, hi = win[-1]
        mine["busy_ns"] = trace.busy_ns(events, lo, hi)
        rank_ctx = SimpleNamespace(events=events, lo=lo, hi=hi)
        mine["per_rank"] = {}
        for m in cell.metrics(True):
            reader = cell.metric_reader(m["name"])
            if hasattr(reader, "per_rank"):
                mine["per_rank"][m["name"]] = reader.per_rank(rank_ctx)
    every = rk.exchange(mine)
    if not rk.lead:
        del events, gen
        rk.finish()
        return 0
    if chips > 1:
        log("ranks: seed-iterations of each shard "
            f"{[r['shard_seed_iterations'] for r in every]}; memory peaks "
            f"{[r['memory_peak_bytes'] for r in every]} bytes")

    metrics, device_info, extra = {}, {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": chips,
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in every)}, {}
    if events is None:
        ctx = SimpleNamespace(setup_s=setup_s, **rec)
    else:
        busy = mine["busy_ns"]
        log(f"trace: {len(events)} events {trace.kinds(events)}, window "
            f"{(hi - lo) * 1e-9:.4f} s, device busy {busy * 1e-9:.4f} s; "
            f"busy of each rank {[r['busy_ns'] * 1e-9 for r in every]} s")
        if busy <= 0:
            log("run: the traced window holds no device event")
            return 1
        work = column_batch.per_iteration(cell.config["work"],
                                          work_sizes(cell, swept),
                                          gen.seeds_per_call)
        peak = peaks(device_info["kind"])
        log(f"work per iteration: {work['flops']} operations, "
            f"{work['bytes']} bytes; peaks {peak['flops']} FLOP/s, "
            f"{peak['bytes']} B/s ({peak['source']})")
        ctx = SimpleNamespace(events=events, lo=lo, hi=hi, work=work,
                              peak=peak, iterations=rec["iterations"],
                              peak_mem_bytes=mem_peak if on_card else None)
        device_info["busy_s"] = sum(r["busy_ns"] for r in every) * 1e-9 / chips
        device_info["window_s"] = (hi - lo) * 1e-9
        extra["breakdown"] = trace.breakdown(events, lo, hi)
        del events
    for m in cell.metrics(bool(args.trace)):
        ctx.per_rank = [r["per_rank"].get(m["name"]) for r in every
                        if "per_rank" in r]
        value = cell.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.trace == 0 and "solve_ms.p90" in metrics:
        log(f"solve_ms.p90 over {len(rec['solve_walls'])} solves")

    answers = gen.sampled_answers()
    check_in = gen.check
    del gen, ctx
    rk.finish()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    prob = ref.problem_from_system(cell.system, swept)
    numbers = chk.check_numbers(prob, check_in, device=device)
    if not numbers:
        log("check: every checked seed lies at the freezing margin")
    gap = chk.answer_gap(prob, answers, device=device)
    if gap is not None:
        numbers["answer_gap"] = gap
    log(f"reference: {time.perf_counter() - t_ref:.3f} s, "
        f"{len(check_in['u'])} checked seeds, "
        f"{0 if answers is None else len(answers['u'])} answers")
    every[0]["banned"] = harness.banned_modules()
    banned = [f"rank {k}: {', '.join(r['banned'])}"
              for k, r in enumerate(every) if r["banned"]]
    if banned:
        log("run: modules of JAX or of the JAX package are loaded: "
            + "; ".join(banned))
        return 1
    correct, rows = chk.judge(numbers, cell.limits)
    for name, value, lim in rows:
        log(f"check {name}: {value!r} limit {lim!r}")
    # a call that raises ends the run without a result, so none failed
    out = {"correct": bool(correct), "attempted": rec["attempted"],
           "failed": 0, "metrics": metrics,
           "device": device_info, **extra,
           "checks": {n: {"value": v, "limit": lim} for n, v, lim in rows}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
