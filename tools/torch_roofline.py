"""Roofline accounting for qoc_tpu_torch's benchmark configs on one CUDA
card (the counterpart of tools/roofline.py).

For each config: count the FLOPs and bytes of one iteration from first
principles for the op sequence the port runs (the engine the card's
ladders pick), take the iteration rate of the matching bench_torch.py
window, and report the achieved FLOP/s and the share of the card's
roofline: float32 outside the tensor cores (``chip_smoke.PEAK_FLOPS``,
67 TFLOP/s) and HBM (``chip_smoke.PEAK_BYTES``, 3.35 TB/s), saying which
of the two bounds the iteration.

A per-iteration engine's count is a list of matrix products, each
counted 2 m k n FLOPs and its two operands read and its result written
once (4 bytes a float): the products the port issues for one
loss-and-gradient, forward and backward (``tests/test_torch_tools.py``
holds each against ``torch.utils.flop_counter.FlopCounterMode`` at a
small shape).  Elementwise passes are not counted, so the bytes are a
floor of the eager op sequence's traffic.  The fused kernels count their
own work (``chip_smoke.segment_work``, ``expm_work``, ``tree_macs``) and
their operands once: kernel 3's once a launch, spread over the
iterations of the window's one launch (``bench_torch.MEGA_ITERS``).

  * pi pulse (window ``pi_pulse_mega``): kernel 3, three chain passes an
    iteration (forward, adjoint, gradient pairing);
  * pi pulse over the tree kernels (``pi_pulse_xla_tree``): kernels 1-2;
  * dim 60, BASELINE config 4 (``cavity_costs_dim60``): pscan, state
    transfer: kernel 7's Q series, the serial sweeps of mat-vecs, the
    power ladders and their pairing (roofline.py's count, with the port's
    products);
  * dim 64 (``dim64_unitary``): the unitary pscan, 2^s sub-steps a step and
    one more column for unitary_scale;
  * dim 200 (``dim200_cavity_128seed``): ``cols_batch``, three passes of
    the stacked products (forward, remat's recompute, backward);
  * the transmon-leakage job on the scan engine (``leakage_xla``).

``--trace DIR`` first traces a few iterations of dim 64, dim 200 and dim
60 with ``qoc_tpu_torch.utils.profiling.trace`` and lists the top device
kernels by time; it runs before the measurements, because torch.profiler
loses device events a few minutes into a process on the card's machine.

Usage:  python tools/torch_roofline.py [--trace DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import bench_torch  # noqa: E402
from chip_smoke import (PEAK_BYTES, PEAK_FLOPS, expm_work,  # noqa: E402
                        segment_work, tree_macs)
from qoc_tpu_torch.utils import profiling  # noqa: E402

F32 = 4
DIM200_SEEDS = 128      # bench_torch's dim200_cavity_128seed window


# ---------------------------------------------------------------------------
# counts: (flops, bytes) of one iteration
# ---------------------------------------------------------------------------


def gemm(count: int, m: int, k: int, n: int):
    """``count`` products [m, k] @ [k, n]."""
    return (2 * count * m * k * n, F32 * count * (m * k + k * n + m * n))


def _total(parts):
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


def pscan_count(T: int, M: int, K: int, order: int, reps: int, V: int):
    """``ops.propagation.pscan_chain`` (mats [K, M, M], weights [K, T],
    psi0 [M, V], order, reps), forward and backward.  Forward: A_t = sum_k
    w_kt mats_k, kernel 7's Q_t (powers 0..order-1 of A_t: order - 2
    products, ``expm_work``), T reps mat-vec sub-steps.  Backward (the
    matvec adjoint): the reverse sweep, the power ladders f_l = A^l psi and
    b_j = (A^T)^j lam (q - 1 products each, q = order - 1), their pairing
    CF = C F and Abar_t = sum B CF^T, then wbar and matsbar (a product of
    [K, M^2] and [M^2, T] each)."""
    q = order - 1
    sub = T * reps
    q_macs = expm_work(T, M, q, 0)[0]
    return _total([
        gemm(1, T, K, M * M),
        (2 * q_macs, F32 * 2 * T * M * M),        # kernel 7: A in, Q out
        gemm(sub, M, M, V),                       # forward sweep
        gemm(sub, M, M, V),                       # reverse sweep
        gemm(2 * sub * (q - 1), M, M, V),         # the two power ladders
        gemm(1, q, q, sub * M * V),               # CF
        gemm(T, M, reps * q * V, M),              # Abar
        gemm(1, K, M * M, T),                     # wbar
        gemm(1, K, T, M * M),                     # matsbar
    ])


def pscan_state_count(p):
    """A state-transfer problem on pscan (``state_transfer_chain``)."""
    return pscan_count(p.steps, 2 * p.state_num, p.ops_len + 1,
                       p.taylor_terms, 1, p.initial_vectors.shape[1])


def pscan_unitary_count(p):
    """A unitary problem on pscan (``evolve_unitary_pscan``): U0 psi0 and
    U0 1 (no gradient), then the chain of the V columns and the
    ones-column with powers 0..taylor_terms of A / 2^s, 2^s sub-steps a
    step."""
    M, V = 2 * p.state_num, p.initial_vectors.shape[1]
    return _total([gemm(1, M, M, V), gemm(1, M, M, 1),
                   pscan_count(p.steps, M, p.ops_len + 1,
                               p.taylor_terms + 1, 1 << p.taylor_scaling,
                               V + 1)])


def cols_count(p, columns: int, remat: bool = True):
    """``parallel.cols_batch.make_xla_batched_loss`` over ``columns``
    state columns: per step and sub-step order - 1 products [M, K'M] @
    [K'M, C]; the backward forms each product's operand cotangent (one
    more product), and remat reruns the forward (one more); then the
    coherent fidelity's four contractions and their backward."""
    from qoc_tpu_torch.parallel.cols_batch import chain_order

    order, scaling = chain_order(p)
    M, N, V = 2 * p.state_num, p.state_num, p.initial_vectors.shape[1]
    Kp = p.ops_len + 1
    passes = 3 if remat else 2
    per = gemm(p.steps * (1 << scaling) * (order - 1) * passes, M, Kp * M,
               columns)
    S = columns // V
    return _total([per, gemm(4, S, N * V, 1), gemm(4, S, 1, N * V)])


def scan_unitary_count(p, inter: bool):
    """The unitary scan (``evolve_unitary`` with ``engine="scan"``):
    A_t = sum_k w_kt mats_k, each P_t by order - 1 products and s
    squarings (and two products each in the backward), the chain of U and
    (``inter``: the trajectory a penalty reads) of the V vectors, the
    final vectors and unitary_scale."""
    T, M, V = p.steps, 2 * p.state_num, p.initial_vectors.shape[1]
    K = p.ops_len + 1
    P = T * (p.taylor_terms - 1 + p.taylor_scaling)
    parts = [gemm(1, T, K, M * M), gemm(1, K, M * M, T),
             gemm(3 * P, M, M, M),
             gemm(2 * T - 1 + T, M, M, M),          # U chain, fwd + bwd
             gemm(1, M, M, V), gemm(1, M, V, M),    # final vecs, fwd + bwd
             gemm(1, M, M, M)]                      # unitary_scale
    if inter:
        parts += [gemm(1, M, M, V), gemm(T + 2 * T - 1, M, M, V)]
    return _total(parts)


def segment_count(p, n_iters: int):
    """Kernel 3, one iteration of a launch of ``n_iters``
    (``chip_smoke.segment_work`` over ``n_iters``): three chain passes of
    the V columns an iteration; its operands, pulse and moments are read
    once a launch."""
    from qoc_tpu_torch.ops.mega import segment_inputs, segment_lanes

    mats, psi0p, _, _, _, order, s = segment_inputs(p, "cpu")
    state_bytes = 3 * F32 * p.ops_len * segment_lanes(p)
    flops, nbytes = segment_work(n_iters, p, mats, psi0p, order, s,
                                 state_bytes)
    return flops / n_iters, nbytes / n_iters


def tree_count(p):
    """Kernels 1-2 (``chip_smoke.tree_macs``) and E psi0, one
    loss-and-gradient of the state-transfer pi pulse."""
    M, V = 2 * p.state_num, p.initial_vectors.shape[1]
    K = p.ops_len + 1
    fwd, bwd = tree_macs(K, M, p.steps, p.taylor_terms - 1, 0)
    return _total([(2 * (fwd + bwd), F32 * (K * M * M + 2 * K * p.steps
                                            + 2 * M * M)),
                   gemm(1, M, M, V), gemm(1, M, V, M)])


# ---------------------------------------------------------------------------
# the configs: count, bench_torch window, units per iteration
# ---------------------------------------------------------------------------


def configs():
    """name -> (bench_torch window, (flops, bytes) an iteration, route)."""
    pi = bench_torch._problem()
    d60, _ = bench_torch._cavity_dim60_problem()
    d64 = bench_torch._dim64_problem()
    d200, _ = bench_torch._dim200_problem()
    leak = bench_torch._leakage_problem()
    return {
        "pi_pulse": ("pi_pulse_mega",
                     segment_count(pi, bench_torch.MEGA_ITERS), "kernel 3"),
        "pi_pulse_tree": ("pi_pulse_xla_tree", tree_count(pi),
                          "kernels 1-2"),
        "dim60": ("cavity_costs_dim60", pscan_state_count(d60),
                  "pscan, kernel 7"),
        "dim64": ("dim64_unitary", pscan_unitary_count(d64),
                  "pscan, kernel 7"),
        "dim200": ("dim200_cavity_128seed", cols_count(d200, DIM200_SEEDS),
                   "xla-cols"),
        "leakage_scan": ("leakage_xla", scan_unitary_count(leak, True),
                         "scan"),
    }


def roofline(flops: float, nbytes: float, iters_per_sec: float) -> dict:
    """Achieved rates and the roofline share of one iteration's work."""
    ops_s, mem_s = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    bound_s = max(ops_s, mem_s)
    return {"gflop_per_iter": flops / 1e9, "gbytes_per_iter": nbytes / 1e9,
            "arithmetic_intensity": flops / nbytes,
            "achieved_tflops": flops * iters_per_sec / 1e12,
            "achieved_tb_per_s": nbytes * iters_per_sec / 1e12,
            "bound_by": "operations" if ops_s >= mem_s else "bytes",
            "bound_ms_per_iter": 1e3 * bound_s,
            "ms_per_iter": 1e3 / iters_per_sec,
            "roofline_share": bound_s * iters_per_sec}


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


def _trace_window(log_dir: str, name: str, fn, top: int = 12) -> dict:
    """Trace ``fn()`` with ``utils.profiling.trace`` and list the top
    device kernels by time."""
    fn()                                    # warm
    torch.cuda.synchronize()
    path = os.path.join(log_dir, name)
    t0 = time.perf_counter()
    with profiling.trace(path):
        fn()
    wall = time.perf_counter() - t0
    events = profiling.kernel_events(os.path.join(path, "trace.json"))
    by_name: dict = {}
    for e in events:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    total = sum(v[0] for v in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": 1e3 * wall, "device_busy_ms": total / 1e3,
            "device_busy_share": total / 1e3 / (1e3 * wall),
            "kernels": len(events),
            "top": [{"name": k[:80], "us": v[0], "count": v[1],
                     "pct": 100 * v[0] / total if total else 0.0}
                    for k, v in rows]}


def trace(log_dir: str, dev, n_iters: int = 3) -> dict:
    """A few iterations of dim 64, dim 200 (128 seeds) and dim 60."""
    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.optim.adam import (init_adam_state, init_batch_adam,
                                          make_throughput_runner)
    from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss

    conv = bench_torch._conv()

    def single(problem, rc=None):
        _, loss_fn = make_forward(problem, rc, lean=True, device=dev)
        run_n = make_throughput_runner(loss_fn, conv)
        s0 = init_adam_state(bench_torch._u0(problem, dev), conv)
        return lambda: bench_torch._sync(run_n(s0, n_iters).u_base)

    d200, _ = bench_torch._dim200_problem()
    run_cols = bench_torch._batched_adam_run(
        make_xla_batched_loss(d200, device=dev), conv)
    u = bench_torch._seeds(d200, DIM200_SEEDS, 0, dev)
    st = init_batch_adam(u, conv)
    d60, rc60 = bench_torch._cavity_dim60_problem()
    return {
        "dim64": _trace_window(log_dir, "dim64",
                               single(bench_torch._dim64_problem())),
        "dim200": _trace_window(log_dir, "dim200", lambda: bench_torch._sync(
            run_cols(u, st, n_iters)[0])),
        "dim60": _trace_window(log_dir, "dim60", single(d60, rc60)),
        "n_iters": n_iters,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None,
                    help="directory for profiler traces (traced first)")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_roofline: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    report = {"card": profiling.card(dev),
              "ceilings": {"f32_tflops": PEAK_FLOPS / 1e12,
                           "hbm_tb_per_s": PEAK_BYTES / 1e12}}
    if args.trace:
        report["trace"] = trace(args.trace, dev)
    cfgs = configs()
    windows = bench_torch.run(dev, only=[w for w, _, _ in cfgs.values()]
                              )["windows"]
    for name, (window, (flops, nbytes), route) in cfgs.items():
        w = windows[window]
        rate = w["median"] / (DIM200_SEEDS if name == "dim200" else 1)
        report[name] = {"window": window, "route": route,
                        "iters_per_sec": rate, "spread": w["spread"],
                        **roofline(flops, nbytes, rate)}
    txt = json.dumps(report, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
