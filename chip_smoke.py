"""Smoke test of qoc_tpu_torch on one CUDA card (H100): build the kernels,
hold each against its plain torch version, then drive ``Grape`` and the
seed-batched layer end to end.

    python3 chip_smoke.py

Phases (each prints one line with its numbers; any failed check raises):

  1. the card (``nvidia-smi`` name and power limit), torch / CUDA versions,
     and the time to build the CUDA kernels from ``qoc_tpu_torch/csrc``;
  2. the tree chain kernels (forward and backward) against
     ``tree_chain_reference`` at four shapes, Tp up to 8192, each launched
     twice (the same bits both times), with the launch geometry (a cluster
     of G blocks in teams of lanes), the residuals' floats, ptxas'
     registers and spills of both kernels, the clock64 split
     (``_cuda.TREE_FWD_CLOCK_PHASES``, ``TREE_BWD_CLOCK_PHASES``) and each
     kernel's device time (``torch.profiler``) beside its time per call;
  3. the fused Adam segment kernel against ``mega_segment_reference``,
     100 iterations on the full-size pi pulse and CNOT problems, launched
     twice (the same bits both times), with its launch geometry (a cluster
     of G blocks) and its clock64 split (each phase's share of the blocks'
     cycles, ``_cuda.MEGA_CLOCK_PHASES``);
  3b. the segment kernel's costs instance against ``mega_segment_reference``
     with the same penalties, 100 iterations on the transmon-leakage job
     (examples/jobs/transmon_leakage.json, BASELINE config 3), all seven
     penalties on a 3-level ladder (unitary, T=1000) and a state transfer
     with speed_up, bandpass and forbidden (T=1000); geometry and clock
     split as in phase 3;
  4. the main path: ``Grape`` on the pi pulse (examples/01_qubit_pi_pulse.py
     settings) and the CNOT (examples/jobs/cnot.json), ``engine="auto"``,
     which must route to the segment kernel and converge; the pi pulse
     with ``engine="tree"``, the per-iteration Adam over the tree kernels;
     and the transmon-leakage job, which must route to the costs instance.
     Launch counts are reset just before each run and read just after;
  5. the state chain kernels (forward and backward) against
     ``state_chain_reference`` at the pi pulse's, the CNOT's and config 3's
     shapes, and at 130 columns (a partial block), with their launch (a
     team of lanes per column);
  6. the fused batched-optimizer kernel (both instances) against
     ``mega_batch_segment_reference``, 20 iterations: the pi pulse at 512
     seeds with a detuning channel, the CNOT at 64 seeds, config 3 at 64
     seeds, the all-seven ladder and the speed_up/bandpass/forbidden state
     transfer at 16 seeds, and the pi sweep again with every seed frozen
     mid-segment; each case's line carries the launch geometry (lanes per
     column, seed groups per block) and the kernel's clock64 split
     (each phase's share of the blocks' cycles, ``_cuda.CLOCK_PHASES``);
  7. the batched main path: ``batched_grape_adam`` (``backend="auto"``,
     routed to kernel 6) on the pi pulse at 512 seeds
     (examples/05_pod_scale_sweep.py's first program),
     the CNOT and config 3 at 64 seeds, and ``backend="pallas"`` (kernels
     4 and 5) on the pi pulse at 256 seeds; launch counts as in phase 4;
  8. the pscan and associative engines on the transmon-cavity job
     (examples/jobs/transmon_cavity.json, BASELINE config 4: M = 120,
     T = 1000): 8a the batched Taylor kernels 7 and 8 against their plain
     versions at config 4's generators, at M = 32 (T = 7), at M = 256
     (order 8, s 2) for T = 64 and 512 and at M = 512 (order 6, s 1) for T
     = 64 and 256, with the Horner reference's error and each case's
     scratch bytes, and beside each kernel the library call for its
     function (``torch.linalg.matrix_exp``, and for the VJP the matrix_exp
     of the 2M block matrix that its backward runs, with the autograd
     call beside it): its time and its distance from the float64 plain
     version (not a gate); 8b
     pscan, associative and scan at config 4's iteration 0, the pscan
     iteration in parts, and a line a direction for the sweep kernels
     (``csrc/pscan_sweep.cu``) at config 4's and config 5's shapes and at
     M = 1024: device time a sweep and a sub-step against the plain loop's
     device and wall time, launches (one a sweep), and the gap to a
     float64 loop (at most four times the float32 loop's); 8c ``Grape`` on
     the job, ``engine="auto"`` (routed to pscan, kernel 7, every sweep in
     the sweep kernels), 2000 of its 5000 iterations; 8d the same with ``engine="associative"`` (kernels 7 and
     8), 20 iterations; 8e the engines under ``torch.func``: kernel 8's
     scratch on config 4 folded to T = 16000 (none), ``batched_grape_adam``
     on config 4 (backend "xla", 16 seeds, 3 iterations) with engine
     "associative" and "pscan", and the pi pulse (4 seeds) with engine
     "tree" against "scan";
  9. the other drivers and modes (``Grape(save=False)``: the card's
     machine has no h5py): 9a the native L-BFGS, L-BFGS-B and BFGS on the
     pi pulse (examples/jobs/spin_pi.json) and the native L-BFGS and
     L-BFGS-B on the CNOT, T = 1000, routed to the tree kernels 1-2 (one
     launch each per loss-and-gradient, kernel 1 also once per aux
     forward), and L-BFGS-B on config 4 for 20 evaluations (pscan, kernel
     7); 9b resume: two segments of 40 iterations against 40, the
     checkpoint's numpy leaves and back, 40, bit for bit, on kernel 3 (the
     pi pulse), its costs instance (config 3) and the per-iteration runner
     over kernels 1-2, and a kernel-3 checkpoint on the per-iteration
     route; 9c the reference gradient of the CNOT in float32 on the card
     against float64 on the CPU, and Grape on the pi pulse in reference
     mode; 9d config 4 at iteration 0 with and without remat (scan) and
     with representation="complex", with each one's peak device memory;
  10. the command line and config 5: 10a ``python -m qoc_tpu_torch run``
     (``cli.main``, no ``--device``: the card) on copies of
     examples/jobs/spin_pi.json, cnot.json and transmon_leakage.json with
     "save": false (the card's machine has no h5py), routed to kernel 3
     with the same loss, reg_loss and iteration bits as ``Grape`` called
     directly, and spin_pi.json with the native L-BFGS on kernels 1-2
     (tree_backward == nfev); the first run traced with
     ``utils.profiling.trace`` (the segment kernel must be among the
     trace's device kernels), ``profiling.time_fn`` and ``memory_stats``
     on the pi pulse's loss; without a card (CUDA_VISIBLE_DEVICES empty)
     ``run`` must exit non-zero with ``entry_device``'s message; 10b
     BASELINE config 5 cut in depth only (examples/torch_05_pod_scale_
     sweep.py: dim 200, M = 400, T = 200, the 64-point detuning grid,
     ``backend="xla-cols"``; 512 seeds, 25 iterations): one
     loss-and-gradient at 512 and 2048 columns timed and traced (the
     device's busy share, the GEMMs' share), its float32 loss and
     gradient at iteration 0 against float64 on the card, ms per
     iteration and peak memory.  Group 10 runs in a process of its own
     (``run_in_new_process``: the profiler's traces need a young
     process).  The full config 5 run (4096 seeds, up to 1200 iterations,
     about 15 minutes) is ``examples/torch_05_pod_scale_sweep.py --full``;
  11. the distribution layer and remat in the batch layer, in a process of
     its own: 11a ``make_mesh()`` with no process group (a world of one on
     NCCL) and qoc_tpu's run_quick through the sweep example's ``--quick``
     functions: 512 pi seeds through ``batched_grape_adam(mesh=...)``,
     routed to kernel 6 (launch counts as in phase 4), with the bits of
     the same call without the mesh, and the 500-iteration detuning sweep
     through ``make_mega_batched_runner(mesh=...)``; 11b
     ``make_shard_map_step`` (64 pi seeds, T = 20, two calls of 40 steps:
     finite statistics, a falling best loss, ms per call); 11c config 5 at
     full width (4096 seeds as one shard of 4096 columns, dim 200) through
     ``make_xla_cols_sharded_runner``, 3 iterations with remat (qoc_tpu's
     default) and without (losses within 1e-6, u' within 1e-5; ms per
     iteration, peak memory, seed-iterations/s); 11d two ranks on the one
     card over gloo (``init_distributed``), each a process of its own, 256
     of 11a's seeds each on kernel 6: the same result on both ranks and
     11a's; 11e ``make_batched_runner(remat=True, backend="xla")`` on
     config 4 (16 seeds, 3 iterations) and one vmapped loss-and-gradient
     against no remat at phase 9d's bars, with peak memory and wall;
  12. the measurement path, in a process of its own: 12a every window of
     bench_torch.py (the counterpart of bench.py) with ``--quick``: a
     finite, positive rate and, in every timed window, exactly the
     launches of the route the card's ladders pick (one launch of kernel 3
     or 6 a window, n of kernels 1-2, 4-5 or 7 for n iterations, none on
     the dim-200 ``xla-cols`` windows and the CPU baselines); 12b
     ``optim.adam.make_throughput_runner`` on the pi pulse over the tree
     kernels, 200 iterations under ``torch.cuda.set_sync_debug_mode
     ("error")`` (no read from the card while the launches queue), with
     the bits of ``make_segment_runner`` with convergence off; 12c the
     converging segment loop (bench.py's wall clock to 1 - 1e-4) ends
     below 1e-4.  The full run is ``python3 bench_torch.py``;
  13. the programs, in a process of its own: 13a the example scripts
     examples/torch_0[1-4]_*.py through their ``main()`` with no device
     (the card), 01-03 at their full budgets, 04 cut to 50 of its 2000
     iterations (phase 8c holds config 4 to its bar on the same route):
     each routed as its docstring says (01 to kernel 3, 02
     and 03 to its costs instance, 04 to pscan over kernel 7; launch
     counts as in phase 4, and the script's own JSON line reports the
     same), 1 - loss within the run's bar of its float64 readout; 13b
     ``python -m pytest tests_gpu`` (the on-card lane, tests_tpu's
     counterpart: kernels 1-7 against float64 host oracles and the
     per-iteration engines, and the card-only tests of the launch spans
     on the profiler's clock, of the float64 readout on the card and of
     the pscan sweep kernels) in a process of its own: 34 tests pass, the
     only skip allowed the h5py one; 13c tools/torch_scaling_evidence.py
     ``--dispatch --collectives 1 --weak 2 --dryrun 2``: kernel 6's
     dispatch cost, its split, and the efficiency at update_step 100 (at
     least EFFICIENCY_BAR), no collective in the hot loop of either sharded
     runner at a world of one on NCCL, the same per-seed losses bit for bit
     on one and two gloo ranks on the one card, and the dry run's four
     mechanisms on two gloo ranks.

Every kernel's entry in the kernels line carries its bound: the larger of
its operations over 67 TFLOP/s (float32 outside the tensor cores) and its
bytes over 3.35 TB/s, at the timed shape.  The second-to-last line is that
JSON object; the last line is ``{"ok": true, "device": {...}}``.  Without
a CUDA device the script exits with code 2 and prints no result.
``--phases 8`` (or ``2-4``, ``5-7``, ``9``, ``10``, ``11``, ``12``,
``13``, comma-separated) runs phase 1 and the groups named, and prints
only their kernels (groups 9-13 add none: they drive the kernels through
new entry points).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from functools import partial
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T_FULL = 1000


def _line(tag: str, **fields) -> None:
    print(f"{tag} " + json.dumps(fields), flush=True)


def _timed_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name: str, reps: int = 20) -> float:
    """The mean device time of the kernels whose name contains ``name``,
    per call of ``fn``, from ``torch.profiler`` (0.0 where the profiler
    sees no device time): the kernel alone, without the host's time per
    call that ``_timed_ms`` also counts when a call is short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if name in e.key)
    return us / 1e3 / reps


def _rel(a, b) -> float:
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


def _abs(a, b) -> float:
    return float((a.detach().double().cpu() - b.detach().double().cpu())
                 .abs().max())


def _generators(K: int, M: int, T: int, rng) -> np.ndarray:
    """iso(-i dt H_k) for random Hermitian H_k, dt = 10/T: near-unitary
    steps, so long chains stay bounded."""
    from qoc_tpu_torch.ops.isomorphism import c_to_r_mat

    n = M // 2
    out = []
    for _ in range(K):
        h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        out.append(c_to_r_mat(-1j * (10.0 / T) * (h + h.conj().T) / 2))
    return np.stack(out).astype(np.float32)


def _on(dev, x: np.ndarray):
    """A contiguous tensor on ``dev`` (``torch.tensor`` keeps a numpy
    array's strides)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


# the least time the card could take (NVIDIA's data sheet, H100 SXM at
# 700 W): float32 outside the tensor cores, and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the float32
    peak and the bytes (each input read once, each output written once)
    over the memory rate."""
    ops_ms, mem_ms = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def chain_macs(T: int, C: int, K: int, M: int, order: int, scaling: int):
    """Multiply-adds of one pass of C state columns through T steps: the
    step generator sum_k w_k mats_k (K M^2) and 2^s * order Taylor
    mat-vecs (M^2 each) per column and step."""
    return T * C * (K + (1 << scaling) * order) * M * M


# the kernels whose ptxas report is read from the build log: a tag, a
# mangled-name pattern and the names of its template arguments
PTXAS_ENTRIES = (
    ("k1", r"tree_forward_kernelILi(\d+)E", ("M",)),
    ("k2", r"tree_backward_kernelILi(\d+)E", ("M",)),
    ("k3", r"mega_segment_kernelILi(\d+)ELb(\d)E", ("M", "costs")),
    ("k4", r"state_chain_forward_kernelILi(\d+)E(?:Li(\d+)E)?", ("M", "KG")),
    ("k5", r"state_chain_backward_kernelILi(\d+)E(?:Li(\d+)E)?", ("M", "KG")),
    ("k6", r"mega_batch_kernelILi(\d+)E(?:Li(\d+)E)?Lb(\d)E",
     ("M", "KG", "costs")),
)


def ptxas_report(log_path: str, tags=None) -> dict:
    """Registers and spill bytes (stores, loads) per kernel instance, read
    from ptxas' report in the build log; ``tags`` keeps those kernels
    only."""
    import re

    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = None
                for tag, pat, args in PTXAS_ENTRIES:
                    k = re.search(pat, m.group(1))
                    if k and (tags is None or tag in tags):
                        name = tag + "".join(
                            f"_{a}{v}" for a, v in zip(args, k.groups())
                            if v is not None)
                        break
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                out.setdefault(name, {})["spill"] = [int(m.group(1)),
                                                     int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(name, {})["registers"] = int(m.group(1))
                name = None
    return out


# phase 2's shapes: (K, M, T, order, scaling)
TREE_SHAPES = [(3, 4, 1000, 2, 0), (6, 8, 1000, 3, 0), (3, 12, 777, 6, 2),
               (3, 4, 5000, 2, 0)]


def tree_macs(K: int, M: int, T: int, order: int, s: int):
    """Multiply-adds of kernels 1 and 2 (``tree_bound``'s count):
    (forward, backward)."""
    step = order - 1 + s
    fwd = T * (K * M * M + step * M ** 3) + (T - 1) * M ** 3
    bwd = (T * (2 * K * M * M + (3 * step + 1) * M ** 3)
           + 2 * (T - 1) * M ** 3)
    return fwd, bwd


def tree_bound(K: int, M: int, T: int, order: int, s: int, nbytes_fwd: int,
               nbytes_bwd: int) -> dict:
    """The bounds of kernels 1 and 2 from the function's own work, the same
    for any implementation.  Forward: per real step the generator sum_k
    w_k mats_k (K M^2 multiply-adds), order - 1 Taylor products and s
    squarings (M^3 each), and the T - 1 products of the chain; backward
    (the VJP from mats, w and gbar): per step the generator and the
    propagator again, the reverse of its products (two each), Pbar_t =
    nu_{t+1} X_t^T and the weight cotangents (K M^2), and the T - 1
    products each of the prefixes X_t and of the cotangents nu_t.  Bytes:
    the function's operands, each read or written once (mats, w and E
    forward; mats, w, gbar and wbar backward)."""
    fwd, bwd = tree_macs(K, M, T, order, s)
    fb, fby = _bound(2 * fwd, nbytes_fwd)
    bb, bby = _bound(2 * bwd, nbytes_bwd)
    return dict(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
                bwd_bound_by=bby)


def _tree_trace(mats, wp, R, order: int, s: int, dev) -> dict:
    """One more launch of each tree kernel with its clock64 counters: each
    phase's share of thread 0's cycles summed over blocks, and the slowest
    block's cycles; and the launch geometry (G blocks, teams of lanes, each
    team's segment of lanes)."""
    import torch

    from qoc_tpu_torch.ops import _cuda

    geo = _cuda.tree_geometry(mats.shape[1], wp.shape[1], mats.shape[0],
                              order, s)
    out = dict(geometry=geo._asdict())
    cf = torch.zeros((geo.blocks, len(_cuda.TREE_FWD_CLOCK_PHASES)),
                     dtype=torch.int64, device=dev)
    _, res = _cuda.tree_forward(mats, wp, order, s, clocks=cf)
    cb = torch.zeros((geo.blocks, len(_cuda.TREE_BWD_CLOCK_PHASES)),
                     dtype=torch.int64, device=dev)
    _cuda.tree_backward(mats, wp, res, R, order, s, clocks=cb)
    for tag, c, phases in (("fwd", cf, _cuda.TREE_FWD_CLOCK_PHASES),
                           ("bwd", cb, _cuda.TREE_BWD_CLOCK_PHASES)):
        out[f"{tag}_clock_split"] = _cuda.clock_split(c, phases)
        out[f"{tag}_clock_cycles_slowest_block"] = int(c.sum(dim=1).max())
    return out


def phase_tree(dev) -> dict:
    """Kernels 1 and 2 against the plain version, forward and gradient, at
    TREE_SHAPES; a second launch of each must repeat the bits."""
    import torch

    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops.tree_chain import (
        _pad_lanes, fused_tree_chain, tree_chain_reference)

    rng = np.random.default_rng(0)
    worst = {"tree_forward": 0.0, "tree_backward": 0.0}
    times = {}
    ptxas = ptxas_report(str(_cuda.build().parent / "build.log"),
                         ("k1", "k2"))
    for K, M, T, order, s in TREE_SHAPES:
        mats = torch.tensor(_generators(K, M, T, rng), device=dev)
        w_h = rng.standard_normal((K, T)).astype(np.float32)
        w_h[0] = 1.0
        R = torch.tensor(rng.standard_normal((M, M)).astype(np.float32),
                         device=dev)
        w = torch.tensor(w_h, device=dev, requires_grad=True)
        E_k = fused_tree_chain(mats, w, order, s)
        (g_k,) = torch.autograd.grad(E_k, w, grad_outputs=R)
        E_r = tree_chain_reference(mats, w, order, s)
        (g_r,) = torch.autograd.grad(E_r, w, grad_outputs=R,
                                     retain_graph=True)
        torch.cuda.synchronize()
        fwd_rel, bwd_rel = _rel(E_k, E_r), _rel(g_k, g_r)
        if not (fwd_rel <= 2e-5 and bwd_rel <= 1e-4):
            raise AssertionError(
                f"tree kernel disagrees at K={K} M={M} T={T} order={order} "
                f"s={s}: forward rel {fwd_rel:.3e} (<= 2e-5), gradient rel "
                f"{bwd_rel:.3e} (<= 1e-4)")
        worst["tree_forward"] = max(worst["tree_forward"], _abs(E_k, E_r))
        worst["tree_backward"] = max(worst["tree_backward"], _abs(g_k, g_r))

        wp = _pad_lanes(w.detach()).contiguous()
        E0, res = _cuda.tree_forward(mats, wp, order, s)
        wbar = _cuda.tree_backward(mats, wp, res, R, order, s)
        E1, res1 = _cuda.tree_forward(mats, wp, order, s)
        wbar1 = _cuda.tree_backward(mats, wp, res1, R, order, s)
        if not (torch.equal(E0, E1) and torch.equal(wbar, wbar1)):
            raise AssertionError(
                f"tree kernels at K={K} M={M} T={T}: a second launch on the "
                "same inputs gave other bits")
        t = tree_bound(K, M, T, order, s, _nbytes(mats, w, E0),
                       _nbytes(mats, w, R, wbar))
        reps = 20
        t.update(
            fwd_ms=_timed_ms(lambda: _cuda.tree_forward(mats, wp, order, s),
                             reps),
            fwd_plain_ms=_timed_ms(
                lambda: tree_chain_reference(mats, w.detach(), order, s),
                reps),
            bwd_ms=_timed_ms(lambda: _cuda.tree_backward(
                mats, wp, res, R, order, s), reps),
            bwd_plain_ms=_timed_ms(lambda: torch.autograd.grad(
                E_r, w, grad_outputs=R, retain_graph=True), reps),
            fwd_device_ms=device_ms(lambda: _cuda.tree_forward(
                mats, wp, order, s), "tree_forward_kernel"),
            bwd_device_ms=device_ms(lambda: _cuda.tree_backward(
                mats, wp, res, R, order, s), "tree_backward_kernel"),
        )
        times[(K, M, T, order, s)] = t
        _line("phase2", K=K, M=M, T=T, order=order, scaling=s,
              fwd_max_rel_err=fwd_rel, grad_max_rel_err=bwd_rel,
              repeat_bit_identical=True,
              residual_floats=res.numel(),
              ptxas={k: v for k, v in ptxas.items()
                     if k in (f"k1_M{M}", f"k2_M{M}")},
              **t, **_tree_trace(mats, wp, R, order, s, dev))
    return {"worst": worst, "times": times}


def _cplx(x):
    if isinstance(x, dict):
        return np.asarray(x["real"], float) + 1j * np.asarray(x["imag"], float)
    return np.asarray(x, dtype=complex)


def _job(name):
    """A job file of examples/jobs as Grape arguments (save=False)."""
    with open(os.path.join(HERE, "examples", "jobs", name)) as f:
        spec = json.load(f)
    kwargs = dict(convergence=spec["convergence"], maxA=spec["maxA"],
                  seed=spec["seed"], method=spec["method"],
                  show_plots=False, save=False)
    for k in ("reg_coeffs", "state_transfer"):
        if k in spec:
            kwargs[k] = spec[k]
    st = spec.get("state_transfer", False)
    target = ([_cplx(v) for v in spec["U"]] if st else _cplx(spec["U"]))
    concerned = ([_cplx(v) for v in spec["states_concerned_list"]] if st
                 else spec["states_concerned_list"])
    return dict(
        args=(_cplx(spec["H0"]), [_cplx(h) for h in spec["Hops"]],
              spec["Hnames"], target, spec["total_time"], spec["steps"],
              concerned),
        kwargs=kwargs)


def _problems():
    """The two full-size problems of the main path, as Grape arguments."""
    import qoc_tpu_torch as q

    pi = dict(
        args=(np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
              ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, T_FULL,
              [np.array([1, 0], dtype=complex)]),
        kwargs=dict(state_transfer=True,
                    convergence={"rate": 0.01, "update_step": 100,
                                 "max_iterations": 5000, "conv_target": 1e-8},
                    maxA=[2 * np.pi * 0.1] * 2, seed=0, method="Adam",
                    show_plots=False, save=False),
    )
    return {"pi_pulse": pi, "cnot": _job("cnot.json"),
            "transmon_leakage": _job("transmon_leakage.json")}


def _ladder(state_transfer: bool):
    """The 3-level ladder with a leakage level of tests/test_mega.py:78-96,
    at T=1000."""
    import qoc_tpu_torch as q

    n = 3
    a = q.annihilate(n)
    H0 = np.diag([0.0, 1.0, 1.95]) * 2 * np.pi
    ops = [a + a.conj().T, 1j * (a - a.conj().T)]
    if state_transfer:
        psi0 = np.zeros(n, complex)
        psi0[0] = 1
        tgt = np.zeros(n, complex)
        tgt[1] = 1
        return dict(args=(H0, ops, ["x", "y"], [tgt], 3.0, T_FULL, [psi0]),
                    kwargs=dict(state_transfer=True, maxA=[0.5, 0.5],
                                seed=0))
    return dict(args=(H0, ops, ["x", "y"], q.transmon_gate(q.SIGMA_X, n),
                      3.0, T_FULL, [0, 1]),
                kwargs=dict(maxA=[0.5, 0.5], seed=0))


def _build_problem(prob):
    from qoc_tpu_torch.models.system import ControlProblem

    kw = {k: v for k, v in prob["kwargs"].items()
          if k in ("state_transfer", "maxA", "seed")}
    return ControlProblem.build(*prob["args"], **kw)


def segment_work(n: int, p, mats, psi0p, order: int, s: int,
                 state_bytes: int):
    """(flops, bytes) of ``n`` Adam iterations in one segment launch: per
    iteration the forward of the V columns, the adjoint sweep and the
    gradient pairing, each one chain pass (``chain_macs``); the operands
    read once, and the pulse and Adam moments (``state_bytes``) read and
    written once, a launch."""
    K, M, V = mats.shape[0], mats.shape[1], psi0p.shape[1]
    macs = 3 * n * chain_macs(p.steps, V, K, M, order, s)
    return 2 * macs, _nbytes(mats, psi0p) + 2 * state_bytes


def _segment_bound(n: int, p, mats, psi0p, order: int, s: int, k) -> dict:
    """Bound of ``n`` Adam iterations in one segment launch
    (``segment_work``)."""
    ms, by = _bound(*segment_work(n, p, mats, psi0p, order, s,
                                  _nbytes(k.u_base, k.m, k.v)))
    return dict(bound_ms=ms, bound_by=by)


def _segment_trace(run, init, u0, n: int, mats, psi0p, Tp: int, order: int,
                   s: int, costs, dev) -> dict:
    """One more launch of kernel 3 with its clock64 counters: each phase's
    share of the blocks' cycles (``_cuda.MEGA_CLOCK_PHASES``), the slowest
    block's cycles per iteration, and the launch geometry (G blocks of a
    cluster, teams of lanes, each team's segment of lanes)."""
    import torch

    from qoc_tpu_torch.ops import _cuda

    geo = _cuda.mega_geometry(mats.shape[1], Tp, mats.shape[0],
                              psi0p.shape[1], order, s,
                              costs=costs is not None,
                              traj=costs is not None and costs.traj)
    clocks = torch.zeros((geo.blocks, len(_cuda.MEGA_CLOCK_PHASES)),
                         dtype=torch.int64, device=dev)
    run(init(u0), n, clocks=clocks)
    return dict(geometry=geo._asdict(),
                clock_split=_cuda.clock_split(clocks,
                                              _cuda.MEGA_CLOCK_PHASES),
                clock_cycles_per_iter_slowest_block=int(
                    clocks.sum(dim=1).max()) / n)


def _same_twice(run, init, u0, n: int, k, name: str) -> None:
    """The kernel is deterministic: a second launch on the same inputs
    gives the same bits."""
    import torch

    k2 = run(init(u0), n)
    if not (torch.equal(k.u_base, k2.u_base) and k.loss == k2.loss
            and k.reg_loss == k2.reg_loss):
        raise AssertionError(f"segment kernel on {name}: a second launch "
                             "on the same inputs gave other bits")


def phase_mega(dev, problems) -> dict:
    """Kernel 3 against the plain segment, 100 iterations, full size."""
    import torch

    from qoc_tpu_torch.ops.mega import (
        make_mega_segment_runner, mega_segment_reference, segment_inputs,
        segment_statics)
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings

    n = 100
    out = {}
    for name, prob in problems.items():
        p = _build_problem(prob)
        conv = ConvergenceSettings.from_dict(prob["kwargs"]["convergence"])
        init, run, unpad = make_mega_segment_runner(p, conv, throughput=True,
                                                    device=dev)
        mats, psi0p, target, maxamp, u0rows, order, s = segment_inputs(p, dev)
        statics = dict(segment_statics(p, conv, throughput=True),
                       order=order, scaling=s)
        k = run(init(p.u0_base), n)
        _same_twice(run, init, p.u0_base, n, k, name)
        r = mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                                   init(p.u0_base), n, **statics)
        # The f32 floor of this trajectory: the plain version in float64.
        # Adam divides each gradient entry by its own RMS, so rounding in
        # small entries moves u by a fraction of the step; at CNOT size
        # the f32 plain version drifts ~1e-4 from float64 in 100
        # iterations, above tests/test_mega.py's 5e-5 (set at 20-30
        # iterations on T <= 32).
        s0 = init(p.u0_base)
        r64 = mega_segment_reference(
            mats.double(), psi0p.double(), target.double(), maxamp.double(),
            u0rows.double(), s0._replace(u_base=s0.u_base.double(),
                                         m=s0.m.double(), v=s0.v.double()),
            n, **statics)
        floor = _abs(r.u_base, r64.u_base)
        u_tol = max(5e-5, 4.0 * floor)
        u_err = _abs(k.u_base, r.u_base)
        loss_err = abs(k.loss - r.loss)
        us_err = abs(k.unitary_scale - r.unitary_scale)
        if not (u_err <= u_tol and loss_err <= 2e-5 and us_err <= 1e-4
                and k.iteration == r.iteration == n):
            raise AssertionError(
                f"segment kernel disagrees on {name}: u {u_err:.3e} "
                f"(<= {u_tol:.3e}), loss {loss_err:.3e} (<= 2e-5), "
                f"unitary_scale {us_err:.3e} (<= 1e-4), iterations "
                f"{k.iteration} vs {r.iteration}")
        seg_ms = _timed_ms(lambda: run(init(p.u0_base), n), 5)
        trace = _segment_trace(run, init, p.u0_base, n, mats, psi0p,
                               k.u_base.shape[1], order, s, None, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                               init(p.u0_base), n, **statics)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(u_err=u_err, seg_ms=seg_ms, plain_ms=plain_ms,
                         **_segment_bound(n, p, mats, psi0p, order, s, k))
        _line("phase3", problem=name, iterations=n, u_max_abs_err=u_err,
              u_tol=u_tol, u_plain_f32_vs_f64=floor, loss_abs_err=loss_err,
              unitary_scale_abs_err=us_err, loss_kernel=k.loss,
              loss_plain=r.loss, repeat_bit_identical=True,
              kernel_ms_per_iter=seg_ms / n, plain_ms_per_iter=plain_ms / n,
              bound_ms_per_iter=out[name]["bound_ms"] / n,
              bound_by=out[name]["bound_by"], **trace)
    return out


def phase_mega_costs(dev, problems) -> dict:
    """Kernel 3's costs instance against the plain segment with the same
    penalties, 100 iterations, full size."""
    import torch

    from qoc_tpu_torch.ops.mega import (
        make_mega_segment_runner, mega_segment_reference, mega_supported,
        segment_costs, segment_inputs, segment_statics)
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings

    n = 100
    conv = ConvergenceSettings.from_dict(
        problems["transmon_leakage"]["kwargs"]["convergence"])
    all_seven = {"amplitude": 0.05, "envelope": 0.02, "dwdt": 0.001,
                 "d2wdt2": 1e-7, "bandpass": 0.2, "band": [0.5, 2.0],
                 "forbidden_coeff_list": [2.0], "states_forbidden_list": [2],
                 "speed_up": 0.5}      # tests/test_mega.py:358-362
    cases = [
        ("transmon_leakage", problems["transmon_leakage"],
         problems["transmon_leakage"]["kwargs"]["reg_coeffs"]),
        ("all_seven_unitary", _ladder(False), all_seven),
        ("state_speed_up_bandpass_forbidden", _ladder(True),
         {"speed_up": 0.5, "bandpass": 0.2, "band": [0.5, 2.0],
          "forbidden_coeff_list": [2.0], "states_forbidden_list": [2]}),
    ]
    out = {}
    for name, prob, rc in cases:
        p = _build_problem(prob)
        if not mega_supported(p, rc):
            raise AssertionError(f"{name}: mega_supported is False")
        init, run, unpad = make_mega_segment_runner(
            p, conv, throughput=True, reg_coeffs=rc, device=dev)
        mats, psi0p, target, maxamp, u0rows, order, s = segment_inputs(p, dev)
        costs = segment_costs(p, rc, dev)
        statics = dict(segment_statics(p, conv, throughput=True),
                       order=order, scaling=s, costs=costs)
        k = run(init(p.u0_base), n)
        _same_twice(run, init, p.u0_base, n, k, name)
        r = mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                                   init(p.u0_base), n, **statics)
        # the f32 floor, as in phase 3: the plain version in float64
        s0 = init(p.u0_base)
        r64 = mega_segment_reference(
            mats.double(), psi0p.double(), target.double(), maxamp.double(),
            u0rows.double(), s0._replace(u_base=s0.u_base.double(),
                                         m=s0.m.double(), v=s0.v.double()),
            n, **statics)
        floor = _abs(r.u_base, r64.u_base)
        u_tol = max(5e-5, 4.0 * floor)
        # reg_loss is held like loss (2e-5) where float32 can hold it; with
        # speed_up at T=1000 it is ~250, where one ulp is 1.5e-5, so it gets
        # the same floor rule as u: 4x the plain version's own f32-vs-f64
        # drift
        reg_floor = abs(r.reg_loss - r64.reg_loss)
        reg_tol = max(2e-5, 4.0 * reg_floor)
        u_err = _abs(k.u_base, r.u_base)
        loss_err = abs(k.loss - r.loss)
        reg_err = abs(k.reg_loss - r.reg_loss)
        us_err = abs(k.unitary_scale - r.unitary_scale)
        if not (u_err <= u_tol and loss_err <= 2e-5 and reg_err <= reg_tol
                and us_err <= 1e-4 and k.iteration == r.iteration == n
                and np.isfinite(k.reg_loss)):
            raise AssertionError(
                f"segment kernel (costs) disagrees on {name}: u "
                f"{u_err:.3e} (<= {u_tol:.3e}), loss {loss_err:.3e} "
                f"(<= 2e-5), reg_loss {reg_err:.3e} (<= {reg_tol:.3e}), "
                f"unitary_scale {us_err:.3e} (<= 1e-4), iterations "
                f"{k.iteration} vs {r.iteration}")
        seg_ms = _timed_ms(lambda: run(init(p.u0_base), n), 3)
        trace = _segment_trace(run, init, p.u0_base, n, mats, psi0p,
                               k.u_base.shape[1], order, s, costs, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                               init(p.u0_base), n, **statics)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(u_err=u_err, seg_ms=seg_ms, plain_ms=plain_ms,
                         **_segment_bound(n, p, mats, psi0p, order, s, k))
        _line("phase3b", problem=name, reg_coeffs=sorted(rc), M=2 * p.state_num,
              T=p.steps, Tp=s0.u_base.shape[1], V=int(psi0p.shape[1]),
              trajectory=costs.traj, bins=int(costs.dftc.shape[1]),
              iterations=n, u_max_abs_err=u_err, u_tol=u_tol,
              u_plain_f32_vs_f64=floor, loss_abs_err=loss_err,
              reg_loss_abs_err=reg_err, reg_loss_tol=reg_tol,
              reg_loss_plain_f32_vs_f64=reg_floor,
              unitary_scale_abs_err=us_err, reg_loss_kernel=k.reg_loss,
              reg_loss_plain=r.reg_loss, repeat_bit_identical=True,
              kernel_ms_per_iter=seg_ms / n,
              plain_ms_per_iter=plain_ms / n,
              bound_ms_per_iter=out[name]["bound_ms"] / n,
              bound_by=out[name]["bound_by"], **trace)
    return out


def _reg_loss_at_start(prob, problem) -> float:
    """reg_loss at iteration 0 (the seeded initial pulse), from the port's
    plain forward on the card."""
    import torch

    from qoc_tpu_torch.models.forward import make_forward

    dev = torch.device("cuda", 0)
    _, loss_fn = make_forward(problem, reg_coeffs=prob["kwargs"]["reg_coeffs"],
                              lean=True, device=dev)
    with torch.no_grad():
        return float(loss_fn(torch.as_tensor(problem.u0_base, device=dev))[0])


# PARITY.md:185-187 (TPU runs; history, not targets)
QOC_TPU_ITERS = {"pi_pulse": 94, "cnot": 1681, "transmon_leakage": 5000}
MEGA = "mega (fused Adam segment CUDA kernel)"
LEAKAGE = "mega (fused Adam segment CUDA kernel, penalties: forbidden, dwdt)"
# each run of the main path: (problem, engine, routing line, kernels that
# must launch during it)
RUNS = [("pi_pulse", "auto", MEGA, ("mega_segment",)),
        ("cnot", "auto", MEGA, ("mega_segment",)),
        ("pi_pulse", "tree", "tree", ("tree_forward", "tree_backward")),
        ("transmon_leakage", "auto", LEAKAGE, ("mega_segment_costs",))]


def phase_grape(problems) -> dict:
    """The main path, through the user's entry point.  Launch counts are
    reset just before each run and read just after; returns their sums."""
    import qoc_tpu_torch as q
    from qoc_tpu_torch.ops import _cuda

    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    failures = []
    for name, engine, want, kernels in RUNS:
        prob = problems[name]
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = q.Grape(*prob["args"], engine=engine, **prob["kwargs"])
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        for kname, cnt in launches.items():
            totals[kname] += cnt
        K, T = len(prob["args"][1]), prob["args"][5]
        fid_gap = abs(res.fidelity_f64 - (1.0 - res.loss))
        fields = dict(problem=name, engine=res.engine,
                      iterations=res.iterations,
                      qoc_tpu_iterations_parity_md=QOC_TPU_ITERS[name],
                      loss=res.loss, reg_loss=res.reg_loss,
                      fidelity_f64=res.fidelity_f64,
                      fidelity_f64_gap=fid_gap, wall_s=wall,
                      iters_per_s=res.iterations / wall, launches=launches)
        ok = (res.engine == want and res.uks.shape == (K, T)
              and np.all(np.isfinite(res.uks))
              and all(launches[kn] >= 1 for kn in kernels))
        if "reg_coeffs" in prob["kwargs"]:
            reg0 = _reg_loss_at_start(prob, res.problem)
            fields.update(reg_loss_iteration_0=reg0,
                          fidelity=1.0 - res.loss)
            _line("phase4", **fields)
            ok = ok and res.reg_loss < reg0 and 1.0 - res.loss >= 0.99
            bar = (f"reg_loss {res.reg_loss:.4e} (< {reg0:.4e} at iteration "
                   f"0), 1 - loss {1.0 - res.loss:.5f} (>= 0.99)")
        else:
            # the pi pulse's float32 loss sits ~1e-6 from its float64
            # readout in qoc_tpu too (1.18e-6 on its CPU scan engine), so its
            # gap is bounded by 2e-6; the CNOT keeps 1e-6
            gap_tol = 2e-6 if name == "pi_pulse" else 1e-6
            _line("phase4", **fields)
            ok = (ok and res.loss < 1e-8 and res.iterations <= 5000
                  and fid_gap <= gap_tol)
            bar = (f"loss {res.loss:.3e} (< 1e-8), {res.iterations} "
                   f"iterations (<= 5000), |fidelity_f64 - (1 - loss)| "
                   f"{fid_gap:.3e} (<= {gap_tol:.0e})")
        if not ok:
            failures.append(
                f"Grape on {name} (engine={engine!r}): routed to "
                f"{res.engine!r} (want {want!r}), launches {launches} "
                f"(want {kernels} >= 1), {bar}")
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


# ---- the seed-batched layer (phases 5-7) ----------------------------------

# examples/05_pod_scale_sweep.py's first program
PI05_CONV = {"rate": 0.01, "update_step": 100, "max_iterations": 2000,
             "conv_target": 1e-6}
ALL_SEVEN = {"amplitude": 0.05, "envelope": 0.02, "dwdt": 0.001,
             "d2wdt2": 1e-7, "bandpass": 0.2, "band": [0.5, 2.0],
             "forbidden_coeff_list": [2.0], "states_forbidden_list": [2],
             "speed_up": 0.5}      # tests/test_mega.py:358-362
SPD_BP_FORB = {"speed_up": 0.5, "bandpass": 0.2, "band": [0.5, 2.0],
               "forbidden_coeff_list": [2.0], "states_forbidden_list": [2]}


def _pi05():
    """The pi pulse of examples/05_pod_scale_sweep.py (maxA 0.7)."""
    import qoc_tpu_torch as q
    from qoc_tpu_torch.models.system import ControlProblem

    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, T_FULL,
        [np.array([1, 0], dtype=complex)], state_transfer=True,
        maxA=[0.7, 0.7], seed=0)


def _detuning_sweep(p, S):
    """One detuning channel (the number operator) with weights 0..0.2 over
    the seeds (examples/05_pod_scale_sweep.py:177-183)."""
    from qoc_tpu_torch.ops.isomorphism import c_to_r_mat

    extra = np.stack([c_to_r_mat(-1j * p.dt * np.diag([0.0, 1.0]))])
    return (extra.astype(np.float32),
            np.linspace(0.0, 0.2, S)[:, None].astype(np.float32))


def phase_state_chain(dev, problems) -> dict:
    """Kernels 4 and 5 against the plain version, forward and gradient."""
    import torch

    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops.state_chain import (
        fused_state_chain, state_chain_reference)
    from qoc_tpu_torch.parallel.cols_batch import chain_inputs

    rng = np.random.default_rng(1)
    cases = [("pi_pulse", _pi05(), 1024),
             ("cnot", _build_problem(problems["cnot"]), 256),
             ("transmon_leakage", _build_problem(problems["transmon_leakage"]),
              128),
             ("pi_pulse_partial_block", _pi05(), 130)]
    worst = {"state_chain_forward": 0.0, "state_chain_backward": 0.0}
    out = {}
    for name, p, C in cases:
        mats, psi0, order, s = chain_inputs(p, device=dev)
        K, M, T = mats.shape[0], mats.shape[1], p.steps
        # realistic weights: drift 1, controls maxA sin(u) with the seeds'
        # pulse statistics; the initial vectors repeated over the columns
        u = rng.standard_normal((T, K - 1, C)) / np.sqrt(T)
        w_h = np.ones((T, K, C), dtype=np.float32)
        w_h[:, 1:] = np.asarray(p.ops_max_amp)[None, :, None] * np.sin(u)
        w = torch.tensor(w_h, device=dev, requires_grad=True)
        p0 = psi0[:, np.arange(C) % psi0.shape[1]].contiguous()
        p0.requires_grad_(True)
        R = torch.tensor(rng.standard_normal((M, C)).astype(np.float32),
                         device=dev)
        out_k = fused_state_chain(mats, w, p0, order, s)
        gk = torch.autograd.grad(out_k, (w, p0), R)
        out_r = state_chain_reference(mats, w, p0, order, s)
        gr = torch.autograd.grad(out_r, (w, p0), R, retain_graph=True)
        torch.cuda.synchronize()
        fwd_rel = _rel(out_k, out_r)
        bwd_rel = max(_rel(gk[0], gr[0]), _rel(gk[1], gr[1]))
        if not (fwd_rel <= 2e-5 and bwd_rel <= 1e-4):
            raise AssertionError(
                f"state chain kernel disagrees on {name} (K={K} M={M} C={C} "
                f"order={order} s={s}): forward rel {fwd_rel:.3e} (<= 2e-5),"
                f" gradient rel {bwd_rel:.3e} (<= 1e-4)")
        worst["state_chain_forward"] = max(worst["state_chain_forward"],
                                           _abs(out_k, out_r))
        worst["state_chain_backward"] = max(
            worst["state_chain_backward"], _abs(gk[0], gr[0]),
            _abs(gk[1], gr[1]))
        wd, pd = w.detach(), p0.detach()
        out_c, traj = _cuda.state_chain_forward(mats, wd, pd, order, s)
        wbar, psibar = _cuda.state_chain_backward(mats, wd, traj, R, order, s)
        macs = chain_macs(T, C, K, M, order, s)
        fb, fby = _bound(2 * macs, _nbytes(mats, wd, pd, out_c, traj))
        bb, bby = _bound(4 * macs, _nbytes(mats, wd, traj, R, wbar, psibar))
        t = dict(
            fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
            bwd_bound_by=bby,
            fwd_ms=_timed_ms(lambda: _cuda.state_chain_forward(
                mats, wd, pd, order, s), 5),
            fwd_plain_ms=_timed_ms(lambda: state_chain_reference(
                mats, wd, pd, order, s), 2),
            bwd_ms=_timed_ms(lambda: _cuda.state_chain_backward(
                mats, wd, traj, R, order, s), 5),
            bwd_plain_ms=_timed_ms(lambda: torch.autograd.grad(
                out_r, (w, p0), R, retain_graph=True), 2),
        )
        out[name] = t
        # kernels 4 and 5's launch: a team of lanes per column, one warp a
        # block
        _line("phase5", problem=name, K=K, M=M, T=T, columns=C, order=order,
              scaling=s, fwd_max_rel_err=fwd_rel, grad_max_rel_err=bwd_rel,
              geometry=_cuda.chain_geometry(M, C)._asdict(), **t)
    return {"worst": worst, "times": out}


# phase 6's cases that run kernel 6's fidelity-only instance
BATCH_PLAIN = ("pi_pulse_sweep", "cnot", "pi_pulse_sweep_frozen_at_10")


def phase_mega_batch(dev, problems) -> dict:
    """Kernel 6 (both instances) against the plain batched segment, 20
    iterations at the batched jobs' full width."""
    import torch

    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.parallel.batch import init_seeds
    from qoc_tpu_torch.parallel.cols_batch import (chain_inputs,
                                                   make_xla_batched_loss)
    from qoc_tpu_torch.parallel.mega_batch import (
        batch_segment_statics, make_mega_batched_runner,
        mega_batch_segment_reference)

    n = 20
    pi = _pi05()
    sweep = _detuning_sweep(pi, 512)
    leak = problems["transmon_leakage"]["kwargs"]
    cnot_conv = problems["cnot"]["kwargs"]["convergence"]
    cases = [
        ("pi_pulse_sweep", pi, PI05_CONV, None, 512, sweep),
        ("cnot", _build_problem(problems["cnot"]), cnot_conv, None, 64, None),
        ("transmon_leakage", _build_problem(problems["transmon_leakage"]),
         leak["convergence"], leak["reg_coeffs"], 64, None),
        ("all_seven_unitary", _build_problem(_ladder(False)),
         leak["convergence"], ALL_SEVEN, 16, None),
        ("state_speed_up_bandpass_forbidden", _build_problem(_ladder(True)),
         leak["convergence"], SPD_BP_FORB, 16, None),
        ("pi_pulse_sweep_frozen_at_10", pi,
         dict(PI05_CONV, max_iterations=10), None, 512, sweep),
    ]
    out = {}
    for name, p, conv_d, rc, S, ex in cases:
        conv = ConvergenceSettings.from_dict(conv_d)
        em, ew = ex if ex is not None else (None, None)
        init, run, _ = make_mega_batched_runner(
            p, conv, extra_channel_mats=em, reg_coeffs=rc, device=dev)
        u0 = init_seeds(p, S, torch.Generator().manual_seed(0), dev)
        V = p.initial_vectors.shape[1]
        statics = batch_segment_statics(conv)
        ew_t = None if ew is None else torch.tensor(ew, device=dev)
        instance = ("mega_batch_segment" if name in BATCH_PLAIN
                    else "mega_batch_segment_costs")
        _cuda.reset_launch_counts()
        k = run(init(u0), n, extra_weights=ew)
        if _cuda.LAUNCHES[instance] != 1:
            raise AssertionError(f"{name}: kernel 6 instance {instance} was "
                                 f"not launched ({_cuda.LAUNCHES})")
        # the plain version keeps the trajectory, as kernel 6 does
        loss32 = make_xla_batched_loss(p, rc, em, remat=False, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = mega_batch_segment_reference(loss32, init(u0), n, V=V,
                                         extra_weights=ew_t, **statics)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        u_err = _abs(k.u_cols, r.u_cols)
        loss_err = _abs(k.losses, r.losses)
        reg_err = _abs(k.reg_losses, r.reg_losses)
        floor = reg_floor = 0.0
        if u_err > 5e-5 or reg_err > 2e-5:
            # the float32 floor of this trajectory: the plain version in
            # float64 (the rule of phases 3 and 3b)
            loss64 = make_xla_batched_loss(p, rc, em, remat=False,
                                           device=dev, dtype=torch.float64)
            s0 = init(u0)
            s64 = s0._replace(**{f: getattr(s0, f).double() for f in (
                "u_cols", "m_cols", "v_cols", "it_cols", "done_cols")})
            r64 = mega_batch_segment_reference(
                loss64, s64, n, V=V,
                extra_weights=None if ew_t is None else ew_t.double(),
                **statics)
            floor = _abs(r.u_cols, r64.u_cols)
            reg_floor = _abs(r.reg_losses, r64.reg_losses)
        u_tol = max(5e-5, 4.0 * floor)
        reg_tol = max(2e-5, 4.0 * reg_floor)
        same_it = torch.equal(k.it_cols, r.it_cols)
        same_done = torch.equal(k.done_cols, r.done_cols)
        ok = (u_err <= u_tol and loss_err <= 2e-5 and reg_err <= reg_tol
              and same_it and same_done)
        if name.endswith("frozen_at_10"):
            ok = ok and bool(torch.all(k.it_cols == 10.0)) and bool(
                torch.all(k.done_cols == 1.0))
        if not ok:
            raise AssertionError(
                f"batched segment kernel disagrees on {name}: u {u_err:.3e} "
                f"(<= {u_tol:.3e}), loss {loss_err:.3e} (<= 2e-5), reg_loss "
                f"{reg_err:.3e} (<= {reg_tol:.3e}), it equal {same_it}, "
                f"done equal {same_done}")
        seg_ms = _timed_ms(lambda: run(init(u0), n, extra_weights=ew), 1)
        # one more launch with the clock64 counters: each phase's share of
        # the blocks' cycles, and the slowest block's cycles per iteration
        clocks = torch.zeros((k.u_cols.shape[2], len(_cuda.CLOCK_PHASES)),
                             dtype=torch.int64, device=dev)
        run(init(u0), n, extra_weights=ew, clocks=clocks)
        split = _cuda.clock_split(clocks)
        block_cycles = int(clocks.sum(dim=1).max()) / n
        cm, _, order, s = chain_inputs(p, em, device=dev)
        C = k.u_cols.shape[2]
        bound, by = _bound(
            2 * 3 * n * chain_macs(p.steps, C, cm.shape[0], cm.shape[1],
                                   order, s),
            _nbytes(cm) + 2 * _nbytes(k.u_cols, k.m_cols, k.v_cols))
        out[name] = dict(u_err=u_err, seg_ms=seg_ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by)
        _line("phase6", problem=name, reg_coeffs=sorted(rc or {}),
              M=2 * p.state_num, T=p.steps, V=V, seeds=S, iterations=n,
              geometry=_cuda.batch_geometry(2 * p.state_num, V, C)._asdict(),
              u_max_abs_err=u_err, u_tol=u_tol, u_plain_f32_vs_f64=floor,
              loss_max_abs_err=loss_err, reg_loss_max_abs_err=reg_err,
              reg_loss_tol=reg_tol, it_final=sorted(set(
                  k.it_cols[0].tolist())),
              kernel_ms_per_iter=seg_ms / n, plain_ms_per_iter=plain_ms / n,
              bound_ms_per_iter=out[name]["bound_ms"] / n,
              bound_by=out[name]["bound_by"], clock_split=split,
              clock_cycles_per_iter_slowest_block=block_cycles)
    return out


def _losses_at_start(p, rc, S, dev):
    """(fidelity, reg) losses [S] of the seeds batched_grape_adam starts
    from (its init_seeds with seed 0), by the plain column-batched loss."""
    import torch

    from qoc_tpu_torch.parallel.batch import init_seeds
    from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss

    u0 = init_seeds(p, S, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        reg, fid = make_xla_batched_loss(p, rc, device=dev)(u0)
    return fid.cpu().numpy(), reg.cpu().numpy()


BATCH = "[qoc-tpu-torch] batch backend: "
BATCH_MEGA = BATCH + "mega (fused batched-optimizer CUDA kernel)"


def phase_batch(dev, problems) -> dict:
    """The batched main path through ``batched_grape_adam``.  Launch counts
    are reset just before each run and read just after; returns their
    sums."""
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.parallel.batch import batched_grape_adam

    leak = problems["transmon_leakage"]["kwargs"]
    rc3 = leak["reg_coeffs"]
    runs = [
        ("pi_pulse", _pi05(), 512, PI05_CONV, None, "auto", BATCH_MEGA,
         ("mega_batch_segment",)),
        ("cnot", _build_problem(problems["cnot"]), 64,
         dict(problems["cnot"]["kwargs"]["convergence"],
              max_iterations=1000), None, "auto", BATCH_MEGA,
         ("mega_batch_segment",)),
        ("transmon_leakage", _build_problem(problems["transmon_leakage"]), 64,
         dict(leak["convergence"], max_iterations=1000), rc3, "auto",
         BATCH + "mega (fused batched-optimizer CUDA kernel, penalties: "
         "forbidden, dwdt)", ("mega_batch_segment_costs",)),
        ("pi_pulse_pallas", _pi05(), 256, dict(PI05_CONV, max_iterations=100),
         None, "pallas", BATCH + "pallas (fused state-chain CUDA kernel + "
         "autograd backward) (forced)",
         ("state_chain_forward", "state_chain_backward")),
    ]
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    failures = []
    for name, p, S, conv, rc, backend, want, kernels in runs:
        fid0, reg0 = _losses_at_start(p, rc, S, dev)
        _cuda.reset_launch_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = batched_grape_adam(p, S, convergence=conv, reg_coeffs=rc,
                                     seed=0, backend=backend, device=dev)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        for kname, cnt in launches.items():
            totals[kname] += cnt
        route = printed.getvalue().strip()
        losses, regs = res["losses"], res["reg_losses"]
        fields = dict(problem=name, route=route, seeds=S,
                      iterations=res["iterations"], wall_s=wall,
                      seed_iterations_per_s=S * res["iterations"] / wall,
                      best_loss=res["best_loss"],
                      median_loss=float(np.median(losses)),
                      median_loss_iteration_0=float(np.median(fid0)),
                      converged=int(np.sum(res["converged"])),
                      launches=launches)
        ok = (route == want and res["uks"].shape == (S, p.ops_len, p.steps)
              and np.all(np.isfinite(res["uks"]))
              and all(launches[kn] >= 1 for kn in kernels))
        if name == "pi_pulse":
            ok = ok and res["best_loss"] < 1e-4
            bar = f"best loss {res['best_loss']:.3e} (< 1e-4)"
        elif name == "cnot":
            stuck = int(np.sum(np.abs(losses - 0.5) < 0.05))
            fields.update(seeds_near_F_0_5=stuck)
            ok = ok and bool(np.all(losses < fid0))
            bar = (f"every final loss below its iteration-0 loss: "
                   f"{int(np.sum(losses < fid0))} of {S}")
        elif name == "transmon_leakage":
            fields.update(best_fidelity=1.0 - res["best_loss"],
                          median_reg_loss=float(np.median(regs)),
                          median_reg_loss_iteration_0=float(np.median(reg0)))
            ok = ok and bool(np.all(regs < reg0))
            bar = (f"every final reg_loss below its iteration-0 value: "
                   f"{int(np.sum(regs < reg0))} of {S}")
        else:
            ok = (ok and launches["state_chain_forward"]
                  == launches["state_chain_backward"] == res["iterations"]
                  and np.median(losses) < np.median(fid0))
            bar = (f"one launch of each per iteration ({res['iterations']})"
                   f", median loss {np.median(losses):.4e} below "
                   f"{np.median(fid0):.4e}")
        _line("phase7", **fields)
        if not ok:
            failures.append(
                f"batched_grape_adam on {name}: routed {route!r} (want "
                f"{want!r}), launches {launches} (want {kernels} >= 1), "
                f"{bar}")
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


# ---- the pscan and associative engines, kernels 7-8 (phase 8) --------------

CONFIG4 = os.path.join(HERE, "examples", "jobs", "transmon_cavity.json")
# 8c's bar on 1 - loss, after 2000 of the job's 5000 iterations (the cut
# keeps the script in its time limit; 1000 iterations reached 0.99970 on
# the card, and qoc_tpu reaches 0.99987751 in 5000 on the CPU, 0.99990577
# on a TPU, PARITY.md:188)
CONFIG4_BAR = 0.999
CONFIG4_ITERATIONS = 2000
# 8a's shapes: (name, T, M, order, scaling); config 4's comes from its job
EXPM_CASES = [("config4", 1000, 120, 14, 0), ("m32_tail", 7, 32, 12, 3),
              ("m256", 64, 256, 8, 2), ("m512", 64, 512, 6, 1),
              ("m256_t512", 512, 256, 8, 2), ("m512_t256", 256, 512, 6, 1)]


def _config4():
    """Config 4's job (Grape keyword arguments) and its problem."""
    from qoc_tpu_torch.models.system import ControlProblem
    from qoc_tpu_torch.utils.jobs import load_job

    job = load_job(CONFIG4)
    job["save"] = False               # no h5py on the card's machine
    names = ("H0", "Hops", "Hnames", "U", "total_time", "steps",
             "states_concerned_list")
    build = ("U0", "dressed_info", "maxA", "initial_guess", "state_transfer",
             "no_scaling", "Taylor_terms", "use_inter_vecs", "seed")
    p = ControlProblem.build(*(job[k] for k in names),
                             **{k: job[k] for k in build if k in job})
    return job, p


def _config4_generators(p, dev):
    """A_t [T, M, M] of config 4 at its seeded initial pulse: what the
    pscan engine hands kernel 7 (powers 0..taylor_terms-1)."""
    import torch

    from qoc_tpu_torch.interop import problem_tensors
    from qoc_tpu_torch.ops.expm import weighted_hamiltonians

    tens = problem_tensors(p, dev)
    u = torch.as_tensor(np.asarray(p.u0_base, np.float32), device=dev)
    w = torch.cat([torch.ones((1, p.steps), device=dev),
                   tens["ops_max_amp"][:, None] * torch.sin(u)])
    return weighted_hamiltonians(tens["mats"], w)


def expm_work(T: int, M: int, order: int, scaling: int):
    """Multiply-adds of kernels 7 and 8 on A [T, M, M]: the forward's
    (order - 1) powers and ``scaling`` squarings per step; the backward's
    recomputed powers and squarings (the last one is not needed), the
    squarings' reverse (2 products each) and the Taylor reverse (2 per
    power)."""
    fwd = T * (order - 1 + scaling) * M ** 3
    bwd = T * (3 * (order - 1) + max(3 * scaling - 1, 0)) * M ** 3
    return fwd, bwd


def phase_expm(dev, p4) -> dict:
    """Kernels 7 and 8 against their plain versions (8a)."""
    import torch

    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops.fused_expm import (
        fused_expm_backward_horner, fused_expm_backward_reference,
        fused_expm_reference)

    rng = np.random.default_rng(8)
    worst = {"expm_forward": 0.0, "expm_backward": 0.0}
    out = {}
    for name, T, M, order, s in EXPM_CASES:
        if name == "config4":
            A = _config4_generators(p4, dev).contiguous()
            assert A.shape == (T, M, M) and order == p4.taylor_terms - 1
        else:
            # |A| ~ 2^s (|H| ~ 2 sqrt(M/2) for _generators' H, dt = 10/T'):
            # the series' terms peak near n = 1 after the scaling
            A = _on(dev, _generators(T, M, 20 * np.sqrt(M // 2) / 2 ** s,
                                     rng))
        G = _on(dev, rng.standard_normal((T, M, M)).astype(np.float32))
        E_k = _cuda.expm_forward(A, order, s)
        E_r = fused_expm_reference(A, order, s)
        Ab_k = _cuda.expm_backward(A, G, order, s)
        Ab_r = fused_expm_backward_reference(A, G, order, s)
        # how far float32 itself drifts: both against the plain version in
        # float64 (the powers peak near n = |A|, so the sum cancels)
        E_64 = fused_expm_reference(A.double(), order, s)
        Ab_64 = fused_expm_backward_reference(A.double(), G.double(), order,
                                              s)
        # kernel 8's association order in plain torch, against the same bar
        horner_rel = _rel(fused_expm_backward_horner(A, G, order, s), Ab_r)
        scratch = {k: _cuda.expm_scratch_bytes(T, M, order, s, k)
                   for k in ("forward", "backward")}
        # the launch's own count (expm_scratch_floats in expm.cuh) agrees
        c_scratch = {k: 4 * _cuda._library().qoc_expm_scratch_floats(
            T, M, s, int(k == "backward")) for k in scratch}
        torch.cuda.synchronize()
        fwd_rel, bwd_rel = _rel(E_k, E_r), _rel(Ab_k, Ab_r)
        if not (fwd_rel <= 2e-5 and bwd_rel <= 1e-4 and horner_rel <= 1e-4
                and c_scratch == scratch):
            raise AssertionError(
                f"expm kernels disagree on {name} (T={T} M={M} order={order} "
                f"s={s}): forward rel {fwd_rel:.3e} (<= 2e-5), backward rel "
                f"{bwd_rel:.3e} (<= 1e-4), Horner reference rel "
                f"{horner_rel:.3e} (<= 1e-4), scratch bytes {scratch} "
                f"(launch: {c_scratch})")
        worst["expm_forward"] = max(worst["expm_forward"], _abs(E_k, E_r))
        worst["expm_backward"] = max(worst["expm_backward"], _abs(Ab_k, Ab_r))
        # the library call for each kernel (not a gate): torch's own
        # matrix_exp, and for the VJP the one matrix_exp that torch's
        # backward of it runs, of [[A^T, G], [0, A^T]], whose top-right
        # block is the cotangent; the autograd call, which reruns the
        # forward too, is timed beside it
        A_lib = A.detach().clone().requires_grad_(True)
        At = A.transpose(-1, -2)
        blk = torch.cat([torch.cat([At, G], -1),
                         torch.cat([torch.zeros_like(At), At], -1)], -2)

        def lib_fwd():
            return torch.linalg.matrix_exp(A)

        def lib_bwd():
            return torch.linalg.matrix_exp(blk)[:, :M, M:]

        def lib_bwd_autograd():
            return torch.autograd.grad(torch.linalg.matrix_exp(A_lib), A_lib,
                                       G)[0]

        lib_errs = dict(
            fwd_library_vs_f64=_abs(lib_fwd(), E_64),
            bwd_library_vs_f64=_abs(lib_bwd(), Ab_64),
            bwd_library_autograd_vs_f64=_abs(lib_bwd_autograd(), Ab_64))
        reps = 10 if T * M ** 3 < 5e9 else 3
        fwd_macs, bwd_macs = expm_work(T, M, order, s)
        fb, fby = _bound(2 * fwd_macs, _nbytes(A, E_k))
        bb, bby = _bound(2 * bwd_macs, _nbytes(A, G, Ab_k))
        t = dict(
            fwd_ms=_timed_ms(lambda: _cuda.expm_forward(A, order, s), reps),
            fwd_plain_ms=_timed_ms(lambda: fused_expm_reference(A, order, s),
                                   reps),
            bwd_ms=_timed_ms(lambda: _cuda.expm_backward(A, G, order, s),
                             reps),
            bwd_plain_ms=_timed_ms(lambda: fused_expm_backward_reference(
                A, G, order, s), reps),
            fwd_library_ms=_timed_ms(lib_fwd, reps),
            bwd_library_ms=_timed_ms(lib_bwd, reps),
            bwd_library_autograd_ms=_timed_ms(lib_bwd_autograd, reps),
            fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
            bwd_bound_by=bby)
        out[name] = t
        _line("phase8a", case=name, T=T, M=M, order=order, scaling=s,
              A_max_abs=float(A.abs().max()), fwd_max_rel_err=fwd_rel,
              bwd_max_rel_err=bwd_rel, fwd_kernel_vs_f64=_rel(E_k, E_64),
              fwd_plain_vs_f64=_rel(E_r, E_64),
              bwd_kernel_vs_f64=_rel(Ab_k, Ab_64),
              bwd_plain_vs_f64=_rel(Ab_r, Ab_64), horner_vs_plain=horner_rel,
              fwd_scratch_bytes=scratch["forward"],
              bwd_scratch_bytes=scratch["backward"],
              fwd_gflop_per_s=2 * fwd_macs / t["fwd_ms"] / 1e6,
              bwd_gflop_per_s=2 * bwd_macs / t["bwd_ms"] / 1e6, **lib_errs,
              **t)
    return {"worst": worst, "times": out}


def _loss_and_grad(loss_fn, u):
    import torch

    u = u.detach().requires_grad_(True)
    reg, _ = loss_fn(u)
    (g,) = torch.autograd.grad(reg, u)
    return float(reg.detach()), g


def phase_engines(dev, job, p4) -> dict:
    """8b: pscan, associative and scan at config 4's iteration 0 on the
    card, and the pscan iteration's parts in CUDA-event time."""
    import torch

    from qoc_tpu_torch.interop import problem_tensors
    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.ops import propagation as prop

    rc = job["reg_coeffs"]
    u0 = torch.as_tensor(np.asarray(p4.u0_base, np.float32), device=dev)
    res = {}
    for engine in ("pscan", "associative", "scan"):
        _, loss_fn = make_forward(p4, reg_coeffs=rc, engine=engine, lean=True,
                                  device=dev)
        reg, g = _loss_and_grad(loss_fn, u0)
        ms = _timed_ms(lambda: _loss_and_grad(loss_fn, u0),
                       1 if engine == "scan" else 5)
        res[engine] = dict(reg=reg, g=g, ms=ms)
    ref = res["pscan"]
    fields = {}
    for engine in ("associative", "scan"):
        r = res[engine]
        reg_rel = abs(r["reg"] - ref["reg"]) / abs(ref["reg"])
        g_rel = float((r["g"] - ref["g"]).abs().max() / ref["g"].abs().max())
        fields[engine] = dict(reg_loss=r["reg"], reg_rel=reg_rel,
                              grad_rel=g_rel, ms_per_iteration=r["ms"])
        if not (reg_rel <= 1e-5 and g_rel <= 5e-4):
            raise AssertionError(
                f"config 4 at iteration 0: {engine} against pscan, reg_loss "
                f"rel {reg_rel:.3e} (<= 1e-5), max|dg| / max|g| {g_rel:.3e} "
                f"(<= 5e-4)")

    # the pscan iteration in parts (CUDA events): kernel 7's Q, the forward
    # sweep, the adjoint sweep, the ladders and pairing; the rest of the
    # iteration (generators, costs, autograd) is the remainder of a whole
    # iteration timed beside them (the sweeps' launch rate follows the
    # host's)
    tens = problem_tensors(p4, dev)
    mats, psi0 = tens["mats"], tens["initial_vectors"]
    order = p4.taylor_terms
    w = torch.cat([torch.ones((1, p4.steps), device=dev),
                   tens["ops_max_amp"][:, None] * torch.sin(u0)])
    vecs, A, Q = prop._pscan_run(mats, w, psi0, order, 1)
    g = torch.randn_like(vecs)
    lams, _ = prop.pscan_reverse_sweep(Q, g, 1)
    parts = dict(
        q_kernel_ms=_timed_ms(
            lambda: prop.batched_taylor_expm(A, order - 1, 0), 5),
        forward_sweep_ms=_timed_ms(lambda: prop.pscan_sweep(Q, psi0, 1), 5),
        adjoint_sweep_ms=_timed_ms(
            lambda: prop.pscan_reverse_sweep(Q, g, 1), 5),
        ladders_pairing_ms=_timed_ms(lambda: prop.pscan_pairing(
            mats, w, A, vecs, lams, order - 1, 1), 5))
    _, pscan_loss = make_forward(p4, reg_coeffs=rc, engine="pscan",
                                 lean=True, device=dev)
    whole = _timed_ms(lambda: _loss_and_grad(pscan_loss, u0), 5)
    parts["rest_ms"] = whole - sum(parts.values())
    parts["whole_ms"] = whole
    sweeps = phase_sweeps(dev, Q, psi0, g)
    _line("phase8b", problem="transmon_cavity", M=2 * p4.state_num,
          T=p4.steps, K=p4.ops_len + 1, order=order,
          pscan_reg_loss=ref["reg"], pscan_ms_per_iteration=ref["ms"],
          pscan_parts=parts, **fields)
    return dict(parts=parts, pscan_ms=ref["ms"],
                associative_ms=res["associative"]["ms"],
                scan_ms=res["scan"]["ms"], sweeps=sweeps)


def _device_busy_ms(fn, reps: int = 5) -> float:
    """The device time of every kernel and copy ``fn`` runs, per call,
    from ``torch.profiler``: what a loop of small launches keeps the card
    busy, without the idle the host leaves between them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def phase_sweeps(dev, Q, psi0, g) -> dict:
    """8b, one line a direction: the sweep kernel (``csrc/pscan_sweep.cu``)
    at config 4's Q, at config 5's shape (T = 200, M = 400, orthogonal
    steps; both on chip) and at M = 1024 (T = 100, through L2), against
    the plain loop on the same card: the kernel's device time a sweep and
    a sub-step, the loop's device busy time and its wall time (the host
    issues its launches), the bound (Q read once at 3.35 TB/s), the
    launches a sweep (one), and the largest gap to a float64 run of the
    loop, which must stay within four times the float32 loop's own."""
    import torch

    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops import propagation as prop

    gen = torch.Generator(device="cpu").manual_seed(5)
    A = torch.randn((200, 400, 400), generator=gen, dtype=torch.float64)
    Q5 = torch.linalg.matrix_exp(((A - A.mT) * 0.025).to(dev)).float()
    psi5 = torch.randn((400, 1), generator=gen).to(dev)
    g5 = torch.randn((201, 400, 1), generator=gen).to(dev)
    # M = 1024: a product of two reflections a step (dense, orthogonal)
    a, b = torch.randn((2, 100, 1024, 1), generator=gen,
                       dtype=torch.float64).to(dev)
    a, b = a / a.norm(dim=-2, keepdim=True), b / b.norm(dim=-2, keepdim=True)
    eye = torch.eye(1024, dtype=torch.float64, device=dev)
    Qw = ((eye - 2 * a @ a.mT) @ (eye - 2 * b @ b.mT)).float()
    psiw = torch.randn((1024, 1), generator=gen).to(dev)
    gw = torch.randn((101, 1024, 1), generator=gen).to(dev)
    cases = {"config4": (Q, psi0, g), "config5": (Q5, psi5, g5),
             "m1024": (Qw, psiw, gw)}
    out = {}
    failures = []
    for direction in ("forward", "reverse"):
        fields = {}
        for case, (Qc, x, gc) in cases.items():
            T, M = Qc.shape[0], Qc.shape[-1]
            geo = _cuda.pscan_geometry(M, x.shape[-1], 1,
                                       direction == "reverse")
            kname = "pscan_%s%s_kernel" % (direction,
                                           "_wide" if geo.wide else "")
            if direction == "forward":
                run = partial(prop.pscan_sweep, Qc, x, 1)
                plain = partial(prop.pscan_sweep_plain, Qc, x, 1)
                exact = partial(prop.pscan_sweep_plain, Qc.double(),
                                x.double(), 1)
            else:
                run = partial(prop.pscan_reverse_sweep, Qc, gc, 1)
                plain = partial(prop.pscan_reverse_plain, Qc, gc, 1)
                exact = partial(prop.pscan_reverse_plain, Qc.double(),
                                gc.double(), 1)
            _cuda.reset_launch_counts()
            got = run()
            launches = _cuda.LAUNCHES["pscan_" + direction]
            want, floor = exact(), plain()
            if direction == "forward":
                got, want, floor = (got,), (want,), (floor,)
            err = max(_abs(a, b) for a, b in zip(got, want))
            f32 = max(_abs(a, b) for a, b in zip(floor, want))
            ms = device_ms(run, kname)
            nbytes = Qc.numel() * 4
            fields[case] = dict(
                T=T, M=M, V=x.shape[-1], kernel=kname, cluster=geo.cluster,
                kernel_ms=ms, kernel_us_per_step=1e3 * ms / T,
                kernel_wall_ms=_timed_ms(run, 5),
                plain_device_ms=_device_busy_ms(plain),
                plain_wall_ms=_timed_ms(plain, 3),
                bound_ms=1e3 * nbytes / 3.35e12, bound_by="b",
                max_abs_err_vs_f64=err, plain_f32_err_vs_f64=f32,
                launches=launches)
            if launches != 1 or not err <= 4 * f32 + 1e-7:
                failures.append(
                    f"8b {direction} sweep at {case}: {launches} launches "
                    f"(want 1), gap to float64 {err:.3e} (want <= 4 x the "
                    f"float32 loop's {f32:.3e})")
        _line("phase8b_sweep", direction=direction, **fields)
        out[direction] = fields
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_config4(dev, job, p4) -> dict:
    """8c and 8d: config 4 through ``Grape``; launch counts are reset just
    before each run and read just after; returns their sums."""
    import qoc_tpu_torch as q
    from qoc_tpu_torch.ops import _cuda

    reg0 = _reg_loss_at_start({"kwargs": job}, p4)
    conv = job["convergence"]
    runs = [("auto", dict(conv, max_iterations=CONFIG4_ITERATIONS)),
            ("associative", dict(conv, max_iterations=20))]
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    failures = []
    for engine, c in runs:
        kw = dict(job, convergence=c, engine=engine, device=dev)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        res = q.Grape(**kw)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        for kname, cnt in launches.items():
            totals[kname] += cnt
        fid_gap = abs(res.fidelity_f64 - (1.0 - res.loss))
        ok = (res.uks.shape == (p4.ops_len, p4.steps)
              and np.all(np.isfinite(res.uks)) and res.reg_loss < reg0
              and launches["expm_forward"] >= 1)
        if engine == "auto":
            # a loss-and-gradient each of iterations 0..N, one forward
            # more for the final readout: every sweep in the kernels
            sweeps = (launches["pscan_reverse"] == res.iterations + 1
                      and launches["pscan_forward"]
                      == launches["pscan_reverse"] + 1)
            ok = (ok and res.engine == "pscan" and sweeps
                  and launches["expm_backward"] == 0
                  and fid_gap <= 5e-5 and 1.0 - res.loss >= CONFIG4_BAR)
            bar = (f"routed to {res.engine!r} (want 'pscan'), launches "
                   f"{launches} (expm_forward >= 1, expm_backward 0, "
                   f"pscan_reverse {res.iterations + 1}, pscan_forward "
                   f"{res.iterations + 2}), "
                   f"|fidelity_f64 - (1 - loss)| {fid_gap:.3e} (<= 5e-5), "
                   f"1 - loss {1.0 - res.loss:.6f} (>= {CONFIG4_BAR})")
        else:
            ok = ok and launches["expm_backward"] >= 1
            bar = f"launches {launches} (expm_forward, expm_backward >= 1)"
        _line("phase8c" if engine == "auto" else "phase8d",
              problem="transmon_cavity", engine=res.engine,
              iterations=res.iterations, loss=res.loss,
              one_minus_loss=1.0 - res.loss, reg_loss=res.reg_loss,
              reg_loss_iteration_0=reg0, fidelity_f64=res.fidelity_f64,
              fidelity_f64_gap=fid_gap, wall_s=wall,
              iters_per_s=res.iterations / wall, launches=launches)
        if not ok:
            failures.append(f"Grape on config 4 (engine={engine!r}): {bar}, "
                            f"reg_loss {res.reg_loss:.4e} (< {reg0:.4e})")
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


FOLD_SEEDS = 16    # 8e (i): config 4's timesteps folded as 16 vmapped seeds
BATCH_SEEDS = 16   # 8e (i)-(ii): config 4 seeds through the vmapped backend
PI_SEEDS = 4       # 8e (iii)


def _iteration_zero_losses(batched_grape_adam, p, S, engine, conv, rc,
                           dev):
    """batched_grape_adam(backend="xla", engine=...) with a progress line
    per iteration: (result, per-seed losses at iteration 0, wall s)."""
    seen = []
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = batched_grape_adam(
            p, S, convergence=dict(conv, update_step=1), reg_coeffs=rc,
            seed=0, backend="xla", engine=engine, device=dev,
            progress=lambda it, losses, done: seen.append(losses))
    return res, seen[0], time.perf_counter() - t0


def phase_torch_func(dev, job, p4) -> dict:
    """8e: the engines under torch.func (the batch layer's vmapped "xla"
    backend) on the card.  (i) kernel 8 on config 4 folded to T = 16000
    takes no memory beyond its output, and batched_grape_adam on config 4
    with engine "associative" launches kernels 7 and 8 every iteration;
    (ii) the same with engine "pscan" starts from the same losses; (iii)
    the pi pulse with engine "tree" launches the tree kernels and matches
    engine "scan" (losses rel 1e-5, gradients max|dg| <= 5e-4 max|g|).
    Launch counts are reset just before each run and read just after;
    returns their sums."""
    import torch

    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.parallel.batch import batched_grape_adam, init_seeds

    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    order = p4.taylor_terms - 1
    A = _config4_generators(p4, dev).contiguous().repeat(FOLD_SEEDS, 1, 1)
    G = torch.randn_like(A)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    Abar = _cuda.expm_backward(A, G, order, 0)
    torch.cuda.synchronize()
    beyond = torch.cuda.max_memory_allocated() - base - _nbytes(Abar)
    want = _cuda.expm_scratch_bytes(A.shape[0], A.shape[1], order, 0,
                                    "backward")
    fold_ms = _timed_ms(lambda: _cuda.expm_backward(A, G, order, 0), 2)
    del A, G, Abar
    torch.cuda.empty_cache()
    _line("phase8e_fold", T=FOLD_SEEDS * p4.steps, M=2 * p4.state_num,
          order=order, bytes_beyond_output=beyond, scratch_bytes=want,
          expm_backward_ms=fold_ms)
    failures = []
    if beyond != want:
        failures.append(f"kernel 8 on T={FOLD_SEEDS * p4.steps} took "
                        f"{beyond} bytes beyond its output (want {want})")

    rc = job["reg_coeffs"]
    conv = dict(job["convergence"], max_iterations=3)
    runs = {}
    for engine in ("associative", "pscan"):
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        res, loss0, wall = _iteration_zero_losses(
            batched_grape_adam, p4, BATCH_SEEDS, engine, conv, rc, dev)
        launches = dict(_cuda.LAUNCHES)
        for kname, cnt in launches.items():
            totals[kname] += cnt
        runs[engine] = loss0
        peak = torch.cuda.max_memory_allocated()
        _line("phase8e_batch", problem="transmon_cavity", engine=engine,
              seeds=BATCH_SEEDS, iterations=res["iterations"], wall_s=wall,
              peak_memory_bytes=peak, losses_iteration_0=loss0.tolist(),
              best_loss=res["best_loss"], launches=launches)
        ok = (res["uks"].shape == (BATCH_SEEDS, p4.ops_len, p4.steps)
              and np.all(np.isfinite(res["uks"]))
              and res["iterations"] >= conv["max_iterations"])
        if engine == "associative":
            it = res["iterations"]
            ok = (ok and launches["expm_forward"] >= it
                  and launches["expm_backward"] >= it)
        if not ok:
            failures.append(f"batched_grape_adam on config 4 with engine "
                            f"{engine!r}: {res['iterations']} iterations, "
                            f"launches {launches}")
    rel = float(np.max(np.abs(runs["pscan"] - runs["associative"])
                       / np.abs(runs["associative"])))
    _line("phase8e_pscan", losses_iteration_0_rel_vs_associative=rel)
    if not rel <= 1e-5:
        failures.append(f"config 4's iteration-0 losses, pscan against "
                        f"associative: rel {rel:.3e} (<= 1e-5)")

    # (iii) the pi pulse through the tree kernels' vmap rules
    p = _pi05()
    u0 = init_seeds(p, PI_SEEDS, torch.Generator().manual_seed(0), dev)
    grads = {}
    for engine in ("tree", "scan"):
        _, loss_fn = make_forward(p, engine=engine, lean=True, device=dev)
        grads[engine] = torch.func.vmap(torch.func.grad(
            lambda u: loss_fn(u)[0]))(u0)
    g_rel = float((grads["tree"] - grads["scan"]).abs().max()
                  / grads["scan"].abs().max())
    losses = {}
    pi_conv = dict(PI05_CONV, max_iterations=3)
    for engine in ("tree", "scan"):
        _cuda.reset_launch_counts()
        res, loss0, wall = _iteration_zero_losses(
            batched_grape_adam, p, PI_SEEDS, engine, pi_conv, None, dev)
        launches = dict(_cuda.LAUNCHES)
        for kname, cnt in launches.items():
            totals[kname] += cnt
        losses[engine] = loss0
        _line("phase8e_tree", problem="pi_pulse", engine=engine,
              seeds=PI_SEEDS, iterations=res["iterations"], wall_s=wall,
              losses_iteration_0=loss0.tolist(), best_loss=res["best_loss"],
              launches=launches)
        if engine == "tree" and not (launches["tree_forward"] >= 1
                                     and launches["tree_backward"] >= 1):
            failures.append(f"batched_grape_adam on the pi pulse with engine "
                            f"'tree' launched {launches}")
    l_rel = float(np.max(np.abs(losses["tree"] - losses["scan"])
                         / np.abs(losses["scan"])))
    _line("phase8e_tree_vs_scan", losses_iteration_0_rel=l_rel,
          grad_max_abs_diff_over_max=g_rel)
    if not (l_rel <= 1e-5 and g_rel <= 5e-4):
        failures.append(f"pi pulse, tree against scan: iteration-0 losses rel "
                        f"{l_rel:.3e} (<= 1e-5), max|dg| / max|g| {g_rel:.3e}"
                        f" (<= 5e-4)")
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


# ---- phase 9: the quasi-Newton drivers, resume, the reference gradient,
# remat and the complex representation ------------------------------------

# 9a runs the job files with conv_target 1e-5.  At their own 1e-8, below
# the float32 floor of 1 - F, the quasi-Newton linesearch fails at that
# floor every iteration (17-20 probes each) until max_iterations, and
# keeps the probe whose float32 loss is lowest: qoc_tpu's native L-BFGS on
# the CNOT ran all 5000 iterations (483 s on the CPU).
DRIVER_CONV_TARGET = 1e-5
# qoc_tpu's Grape on the CPU (JAX 0.9.0) at these settings: 1 - loss, the
# ceiling of the bar, which sits between 0.999 and them
# (tools/quasi_newton_bars.py --package qoc_tpu).  Its L-BFGS-B on the
# CNOT stops at the F = 0.25 critical point next to the seeded start
# (loss 0.7501, g^2 6.9e-6) after 17 evaluations; the port's, with other
# float32 rounding, passes it, on the CPU and on the card.
QOC_TPU_1ML = {("spin_pi", "LBFGS"): 1.0000019, ("spin_pi", "L-BFGS-B"):
               0.9999952, ("spin_pi", "BFGS"): 1.0000017,
               ("cnot", "LBFGS"): 0.9999958, ("cnot", "L-BFGS-B"): 0.25}
DRIVER_BAR = 0.9999
# The float64 readout's gap: phase 4's bars (pi pulse 2e-6, CNOT 1e-6) or
# twice the readout's own float32 floor, whichever is larger.  The floor
# is the largest |fidelity_f64 - (1 - loss)| of the forward that reported
# the run's loss at READOUT_SAMPLES pulses within 1e-3 of the final one
# (phase 3's rule: a bar no tighter than the plain f32-vs-f64 drift).
# Phase 4's bars are the segment kernel's.  The per-iteration engines'
# float32 readout at T = 1000 sits up to 1.3e-6 to 5.2e-6 from float64
# within 1e-3 of each run's final pulse (tools/quasi_newton_bars.py
# --floor, the port on the CPU), whatever the driver, and qoc_tpu's own
# quasi-Newton runs end 1.4e-6 to 2.7e-6 from float64 at these settings on
# the CPU (the same tool).
GAP_BAR = {"spin_pi": 2e-6, "cnot": 1e-6}
# The ceiling of that bar: twice the largest of those CPU floors (5.2e-6),
# so a float32 readout that drifts on the card cannot widen its own bar
# without end.
GAP_CEILING = 2 * 5.2e-6
READOUT_SAMPLES = 8
DRIVER_RUNS = [("spin_pi", "LBFGS"), ("spin_pi", "L-BFGS-B"),
               ("spin_pi", "BFGS"), ("cnot", "LBFGS"), ("cnot", "L-BFGS-B")]
RESUME_N = 40          # iterations per segment in 9b
REFERENCE_BAR = 0.9999  # 9c, tests/test_grape_e2e.py:50 (loss < 1e-4)
CONFIG4_LBFGSB_ITERATIONS = 20


class _DriverClock:
    """Host seconds spent inside the optimizer of a Grape run (the scipy
    bridge, or the native L-BFGS segments), synchronised with the card:
    the run's wall without its set-up and its final analysis."""

    def __init__(self):
        import qoc_tpu_torch.grape as grape_mod

        self.mod = grape_mod
        self.seconds = 0.0

    def _timed(self, fn):
        import torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        return run

    def __enter__(self):
        self.scipy = self.mod.run_scipy_optimizer
        self.lbfgs = self.mod.make_lbfgs_runner
        self.mod.run_scipy_optimizer = self._timed(self.scipy)

        def make_lbfgs(*a, **k):
            init, run = self.lbfgs(*a, **k)
            return init, self._timed(run)
        self.mod.make_lbfgs_runner = make_lbfgs
        return self

    def __exit__(self, *exc):
        self.mod.run_scipy_optimizer = self.scipy
        self.mod.make_lbfgs_runner = self.lbfgs


def _readout_floor(p, u_base, lean: bool, dev) -> float:
    """The float32 readout's floor around ``u_base``: the largest
    |fidelity_f64 - (1 - loss)| of the lean (``lean``) or analysis
    forward at READOUT_SAMPLES pulses u_base + 1e-3 N(0, 1), seed 0."""
    import torch

    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.utils import analysis

    forward, loss_fn = make_forward(p, lean=lean, device=dev)
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(READOUT_SAMPLES):
        u = (u_base + 1e-3 * rng.standard_normal(u_base.shape)).astype(
            np.float32)
        with torch.no_grad():
            out = (loss_fn(torch.as_tensor(u, device=dev))[1] if lean
                   else forward(torch.as_tensor(u, device=dev)))
        f64 = analysis.fidelity_f64(p, analysis.uks_from_base(p, u))
        worst = max(worst, abs(f64 - (1.0 - float(out.loss))))
    return worst


def phase_drivers(dev) -> dict:
    """9a: Grape with the native L-BFGS, BFGS and L-BFGS-B on the pi pulse
    (examples/jobs/spin_pi.json) and the CNOT (examples/jobs/cnot.json),
    T = 1000, conv_target 1e-5, engine "auto": each routes to the tree kernels, which launch
    once per loss-and-gradient (kernel 1 also once per aux forward of the
    native L-BFGS, one per segment); 1 - loss and the float64 readout's
    gap meet their bars (GAP_BAR, at most GAP_CEILING).  Returns the
    launch counts' sums."""
    import qoc_tpu_torch as q
    from qoc_tpu_torch.ops import _cuda

    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    failures = []
    out = {}
    for name, method in DRIVER_RUNS:
        prob = _job(name + ".json")
        kw = dict(prob["kwargs"], method=method,
                  convergence=dict(prob["kwargs"]["convergence"],
                                   conv_target=DRIVER_CONV_TARGET))
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with _DriverClock() as clock:
            res = q.Grape(*prob["args"], device=dev, **kw)
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        for kname, cnt in launches.items():
            totals[kname] += cnt
        segments = len(res.history.iterations) if method == "LBFGS" else 0
        fid_gap = abs(res.fidelity_f64 - (1.0 - res.loss))
        # the native L-BFGS reports the lean forward's loss, the scipy
        # bridge the analysis forward's
        floor = _readout_floor(res.problem, res.u_base,
                               lean=method == "LBFGS", dev=dev)
        gap_bar = min(max(GAP_BAR[name], 2.0 * floor), GAP_CEILING)
        fields = dict(
            problem=name, method=method, engine=res.engine,
            iterations=res.iterations, evaluations=res.nfev,
            evaluations_per_iteration=res.nfev / max(res.iterations, 1),
            aux_forwards=segments, loss=res.loss,
            one_minus_loss=1.0 - res.loss,
            qoc_tpu_cpu_one_minus_loss=QOC_TPU_1ML[(name, method)],
            fidelity_f64=res.fidelity_f64,
            fidelity_f64_gap=fid_gap, readout_floor=floor, gap_bar=gap_bar,
            gap_ceiling=GAP_CEILING,
            wall_s=wall, driver_s=clock.seconds,
            ms_per_evaluation=1e3 * clock.seconds / res.nfev,
            launches=launches)
        out[(name, method)] = fields
        _line("phase9a", **fields)
        ok = (res.engine == "tree" and np.all(np.isfinite(res.uks))
              and launches["tree_backward"] == res.nfev >= 1
              and launches["tree_forward"] == res.nfev + segments
              and 1.0 - res.loss >= DRIVER_BAR
              and fid_gap <= gap_bar)
        if not ok:
            failures.append(
                f"Grape on {name} with {method}: routed to {res.engine!r} "
                f"(want 'tree'), launches {launches} (tree_backward = "
                f"{res.nfev} evaluations, tree_forward = evaluations + "
                f"{segments} aux forwards), 1 - loss {1.0 - res.loss:.7f} "
                f"(>= {DRIVER_BAR}), |fidelity_f64 - (1 - loss)| "
                f"{fid_gap:.3e} (<= {gap_bar:.3e})")
    if failures:
        raise AssertionError("; ".join(failures))
    return dict(launches=totals, runs=out)


def phase_config4_lbfgsb(dev, job, p4) -> dict:
    """9a on config 4: Grape with L-BFGS-B for 20 evaluations (scipy's
    maxfun = max_iterations), routed to pscan (kernel 7 every
    evaluation): reg_loss below its value at iteration 0, all finite."""
    import qoc_tpu_torch as q
    from qoc_tpu_torch.ops import _cuda

    reg0 = _reg_loss_at_start({"kwargs": job}, p4)
    kw = dict(job, method="L-BFGS-B", device=dev,
              convergence=dict(job["convergence"],
                               max_iterations=CONFIG4_LBFGSB_ITERATIONS))
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with _DriverClock() as clock:
        res = q.Grape(**kw)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    fields = dict(problem="transmon_cavity", method="L-BFGS-B",
                  engine=res.engine, iterations=res.iterations,
                  evaluations=res.nfev, loss=res.loss, reg_loss=res.reg_loss,
                  reg_loss_iteration_0=reg0, wall_s=wall,
                  driver_s=clock.seconds,
                  ms_per_evaluation=1e3 * clock.seconds / res.nfev,
                  launches=launches)
    _line("phase9a_config4", **fields)
    ok = (res.engine == "pscan" and launches["expm_forward"] >= res.nfev
          and res.reg_loss < reg0 and np.all(np.isfinite(res.uks))
          and np.isfinite(res.loss))
    if not ok:
        raise AssertionError(
            f"Grape on config 4 with L-BFGS-B: routed to {res.engine!r} "
            f"(want 'pscan'), launches {launches} (expm_forward >= "
            f"{res.nfev} evaluations), reg_loss {res.reg_loss:.4e} (< "
            f"{reg0:.4e} at iteration 0), finite {np.isfinite(res.loss)}")
    return fields


def _bit_identical(a, b) -> bool:
    import torch

    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("u_base", "m", "v"))
            and a.lr == b.lr and a.iteration == b.iteration
            and a.done == b.done)


def phase_resume(dev, problems) -> dict:
    """9b: two segments of n iterations against n, the checkpoint's numpy
    leaves and back (``checkpoint_leaves`` -> ``state_from_leaves``), then
    n: u, m, v, lr and the iteration bit for bit, on the segment kernel
    (the pi pulse; config 3 through its costs instance) and on the
    per-iteration runner over the tree kernels (the pi pulse); then a
    segment-kernel checkpoint restored into the per-iteration runner,
    whose next reg_loss agrees with the kernel's within phase 3's loss bar
    (2e-5)."""
    import torch

    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops.mega import make_mega_segment_runner
    from qoc_tpu_torch.optim.adam import (init_adam_state,
                                          make_segment_runner)
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.utils.checkpoint import (checkpoint_leaves,
                                                state_from_leaves)

    n = RESUME_N
    # no stop inside the 2n iterations
    open_conv = {"conv_target": 0.0, "min_grad": 0.0,
                 "max_iterations": 10 * n}
    cases = {}
    for name, route in (("pi_pulse", "segment"),
                        ("transmon_leakage", "segment_costs"),
                        ("pi_pulse", "tree")):
        prob = problems[name]
        p = _build_problem(prob)
        conv = ConvergenceSettings.from_dict(
            dict(prob["kwargs"]["convergence"], **open_conv))
        rc = prob["kwargs"].get("reg_coeffs")
        if route == "tree":
            _, loss_fn = make_forward(p, reg_coeffs=rc, engine="tree",
                                      lean=True, device=dev)
            run_it = make_segment_runner(loss_fn, conv)
            s0 = init_adam_state(torch.as_tensor(
                np.asarray(p.u0_base, np.float32), device=dev), conv)
            Tp = p.steps

            def advance(s, run_it=run_it):
                return run_it(s, s.iteration + n)
        else:
            init, run_seg, _ = make_mega_segment_runner(
                p, conv, reg_coeffs=rc, device=dev)
            s0 = init(p.u0_base)
            Tp = s0.u_base.shape[1]

            def advance(s, run_seg=run_seg):
                return run_seg(s, n)
        _cuda.reset_launch_counts()
        straight = advance(advance(s0))
        half = advance(s0)
        leaves = checkpoint_leaves(half, p.steps)
        resumed = advance(state_from_leaves(leaves, half.iteration, p.steps,
                                            Tp, dev))
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        same = _bit_identical(resumed, straight)
        cases[f"{name}_{route}"] = dict(same=same, launches=launches,
                                        half=half, p=p, conv=conv, rc=rc)
        _line("phase9b", problem=name, route=route, iterations=2 * n,
              bit_identical=same, loss=resumed.loss,
              reg_loss=resumed.reg_loss, launches=launches)
        if not same:
            raise AssertionError(
                f"resume on {name} ({route}): the checkpoint's round trip "
                "changed the bits of u, m, v, lr or the iteration")
        want = {"segment": "mega_segment",
                "segment_costs": "mega_segment_costs"}.get(route)
        if want and launches.get(want, 0) < 3:
            raise AssertionError(f"resume on {name} ({route}): {want} "
                                 f"launched {launches.get(want, 0)} times")
        if route == "tree" and not (launches.get("tree_forward", 0) >= 4 * n
                                    and launches.get("tree_backward", 0)
                                    >= 4 * n):
            raise AssertionError(f"resume on {name} (tree): launches "
                                 f"{launches}")

    # a segment-kernel checkpoint on the per-iteration route
    c = cases["pi_pulse_segment"]
    p, conv, half = c["p"], c["conv"], c["half"]
    _, run_seg, _ = make_mega_segment_runner(p, conv, device=dev)
    kernel_next = run_seg(half, 1)
    _, loss_fn = make_forward(p, engine="tree", lean=True, device=dev)
    per_it = make_segment_runner(loss_fn, conv)(
        state_from_leaves(checkpoint_leaves(half, p.steps), half.iteration,
                          p.steps, p.steps, dev), half.iteration + 1)
    gap = abs(per_it.reg_loss - kernel_next.reg_loss)
    _line("phase9b_cross", problem="pi_pulse", iteration=half.iteration,
          reg_loss_segment_kernel=kernel_next.reg_loss,
          reg_loss_per_iteration=per_it.reg_loss, abs_diff=gap)
    if not gap <= 2e-5:
        raise AssertionError(
            f"segment checkpoint on the per-iteration route: reg_loss "
            f"{per_it.reg_loss:.7e} against the kernel's "
            f"{kernel_next.reg_loss:.7e} ({gap:.3e} > 2e-5)")
    return {k: v["same"] for k, v in cases.items()}


def _reference_cnot_loss(p, dtype, device):
    """The CNOT's lean loss in reference mode on the associative engine
    (models.forward with gradient_mode="reference"), in ``dtype``: the
    reference Function of the step propagators, their product tree and
    the coherent fidelity."""
    import torch

    from qoc_tpu_torch.ops.inner_products import inner_product_2d
    from qoc_tpu_torch.ops.propagation import (chain_product_tree,
                                               step_propagators_ref_grad)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    mats, U0, psi0 = dev(p.mats), dev(p.U0_iso), dev(p.initial_vectors)
    target, max_amp = dev(p.target_vectors), dev(p.ops_max_amp)

    def loss(u):
        w = torch.cat([torch.ones((1, p.steps), dtype=dtype, device=device),
                       max_amp[:, None] * torch.sin(u)])
        P = step_propagators_ref_grad(mats, w, p.taylor_terms,
                                      p.taylor_scaling)
        final = torch.matmul(chain_product_tree(P), U0)
        return 1.0 - inner_product_2d(torch.matmul(final, psi0), target,
                                      p.state_num)
    return loss


def phase_reference(dev, problems) -> dict:
    """9c: the reference-mode gradient of the CNOT at iteration 0 on the
    card in float32 (models.forward, associative engine) against the same
    Function in float64 on the CPU (rel 1e-4 of max|g|); Grape on the pi
    pulse (spin_pi.json, tests/test_grape_e2e.py:50's convergence) in
    reference mode reaches 1 - loss >= 0.9999."""
    import torch

    import qoc_tpu_torch as q
    from qoc_tpu_torch.models.forward import make_forward

    prob = _job("cnot.json")
    p = _build_problem(prob)
    _, loss_fn = make_forward(p, gradient_mode="reference",
                              engine="associative", lean=True, device=dev)
    if loss_fn.resolved_engine != "associative":
        raise AssertionError("the CNOT's reference-mode forward resolved to "
                             f"{loss_fn.resolved_engine!r}")
    u = torch.as_tensor(np.asarray(p.u0_base, np.float32),
                        device=dev).requires_grad_(True)
    reg, _ = loss_fn(u)
    (g32,) = torch.autograd.grad(reg, u)
    u64 = torch.as_tensor(np.asarray(p.u0_base, np.float64)).requires_grad_(
        True)
    loss64 = _reference_cnot_loss(p, torch.float64, "cpu")(u64)
    (g64,) = torch.autograd.grad(loss64, u64)
    g32 = g32.double().cpu()
    rel = float((g32 - g64).abs().max() / g64.abs().max())
    loss_gap = abs(float(reg.detach()) - float(loss64.detach()))
    fields = dict(problem="cnot", loss_f32=float(reg.detach()),
                  loss_f64=float(loss64.detach()), loss_abs_diff=loss_gap,
                  grad_rel=rel, grad_max_abs=float(g64.abs().max()))
    _line("phase9c_gradient", **fields)
    if not rel <= 1e-4:
        raise AssertionError(f"reference gradient of the CNOT at iteration "
                             f"0: float32 on the card against float64 on "
                             f"the CPU, max|dg| / max|g| {rel:.3e} "
                             "(<= 1e-4)")

    pi = _job("spin_pi.json")
    kw = dict(pi["kwargs"], gradient_mode="reference",
              convergence={"rate": 0.01, "update_step": 50,
                           "max_iterations": 1000, "conv_target": 1e-4})
    t0 = time.perf_counter()
    res = q.Grape(*pi["args"], device=dev, **kw)
    wall = time.perf_counter() - t0
    _line("phase9c_grape", problem="spin_pi", gradient_mode="reference",
          engine=res.engine, iterations=res.iterations, loss=res.loss,
          one_minus_loss=1.0 - res.loss, fidelity_f64=res.fidelity_f64,
          wall_s=wall, ms_per_iteration=1e3 * wall / max(res.iterations, 1))
    if not (res.engine == "scan" and 1.0 - res.loss >= REFERENCE_BAR):
        raise AssertionError(
            f"Grape on the pi pulse in reference mode: engine "
            f"{res.engine!r} (want 'scan'), 1 - loss {1.0 - res.loss:.6f} "
            f"(>= {REFERENCE_BAR})")
    return dict(grad_rel=rel, iterations=res.iterations, wall_s=wall)


def _peak_loss_and_grad(loss_fn, u0, dev):
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    reg, g = _loss_and_grad(loss_fn, u0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return reg, g, torch.cuda.max_memory_allocated() - base, ms


def phase_remat_complex(dev, job, p4) -> dict:
    """9d: config 4 at iteration 0 on the scan engine with and without
    remat (reg_loss rel 1e-5, max|dg| <= 1e-4 max|g|; the peak device
    memory of each loss-and-gradient), and representation="complex"
    against the iso forward on the associative engine (reg_loss rel 1e-5,
    max|dg| <= 1e-4 max|g|)."""
    import torch

    from qoc_tpu_torch.models.forward import make_forward

    rc = job["reg_coeffs"]
    u0 = torch.as_tensor(np.asarray(p4.u0_base, np.float32), device=dev)
    res = {}
    for name, kw in (("scan", dict(engine="scan")),
                     ("scan_remat", dict(engine="scan", remat=True)),
                     ("associative", dict(engine="associative")),
                     ("complex", dict(representation="complex"))):
        _, loss_fn = make_forward(p4, reg_coeffs=rc, lean=True, device=dev,
                                  **kw)
        reg, g, peak, ms = _peak_loss_and_grad(loss_fn, u0, dev)
        res[name] = dict(reg=reg, g=g, peak=peak, ms=ms,
                         engine=loss_fn.resolved_engine)

    def compare(a, b):
        ra, rb = res[a], res[b]
        return (abs(ra["reg"] - rb["reg"]) / abs(rb["reg"]),
                float((ra["g"] - rb["g"]).abs().max() / rb["g"].abs().max()))

    remat_reg, remat_g = compare("scan_remat", "scan")
    cpx_reg, cpx_g = compare("complex", "associative")
    cpx_scan_reg, cpx_scan_g = compare("complex", "scan")
    _line("phase9d", problem="transmon_cavity",
          **{f"{k}_reg_loss": v["reg"] for k, v in res.items()},
          **{f"{k}_peak_bytes": v["peak"] for k, v in res.items()},
          **{f"{k}_ms": v["ms"] for k, v in res.items()},
          complex_engine=res["complex"]["engine"],
          remat_reg_rel=remat_reg, remat_grad_rel=remat_g,
          complex_reg_rel=cpx_reg, complex_grad_rel=cpx_g,
          complex_vs_scan_reg_rel=cpx_scan_reg,
          complex_vs_scan_grad_rel=cpx_scan_g)
    ok = (remat_reg <= 1e-5 and remat_g <= 1e-4 and cpx_reg <= 1e-5
          and cpx_g <= 1e-4 and res["complex"]["engine"] == "complex")
    if not ok:
        raise AssertionError(
            f"config 4 at iteration 0: remat against none reg_loss rel "
            f"{remat_reg:.3e} (<= 1e-5), max|dg| / max|g| {remat_g:.3e} "
            f"(<= 1e-4); complex against iso reg_loss rel {cpx_reg:.3e} "
            f"(<= 1e-5), max|dg| / max|g| {cpx_g:.3e} (<= 1e-4)")
    return {k: dict(peak=v["peak"], ms=v["ms"]) for k, v in res.items()}


# ---- phase 10: the command line and config 5 -----------------------------

# 10a's runs of ``python -m qoc_tpu_torch run``: (job file, changes to it,
# kernels that must launch, the routing line's engine).  Each job runs
# from a temporary copy with "save": false (the card's machine has no
# h5py); the L-BFGS run takes phase 9a's conv_target (DRIVER_CONV_TARGET).
CLI_RUNS = [
    ("spin_pi.json", {}, ("mega_segment",), MEGA),
    ("cnot.json", {}, ("mega_segment",), MEGA),
    ("transmon_leakage.json", {}, ("mega_segment_costs",), LEAKAGE),
    ("spin_pi.json", {"method": "LBFGS"}, ("tree_forward", "tree_backward"),
     "tree"),
]
# 10b: config 5 cut in depth only (examples/torch_05_pod_scale_sweep.py
# at dim 200, T = 200, the 64-point grid), and its iteration-0 check.
# 25 iterations: at 0.62 s an iteration (host-bound) 100 took 62 s, more
# than this group's share of the script's time, and since the column loss
# recomputes each step in the backward pass (qoc_tpu's default) an
# iteration takes about 1.05 s.
C5_CUT = dict(n_seeds=512, n_grid=64, max_iterations=25, chunk=512)
C5_CHECK_SEEDS = 8
# one loss-and-gradient at the cut's and the full run's chunk widths,
# timed (profiling.time_fn) and traced (profiling.trace)
C5_PROFILE_COLUMNS = (512, 2048)
# The card's float32 loss and gradient at iteration 0 against float64 of
# the same arithmetic on the card: |d reg_loss| <= C5_LOSS_BAR and
# max|dg| <= C5_GRAD_BAR max|g|.  On the CPU the same inputs give 2.7e-8
# and 1.06e-6 (tests/test_torch_config5.py holds them 5x inside these
# bars); the bars leave cuBLAS another order of its float32 sums.
C5_LOSS_BAR = 1e-6
C5_GRAD_BAR = 1e-5
XLA_COLS = "xla-cols (column-batched torch chain) (forced)"


def _cli_job(name: str, tmp: str, tag: int, changes: dict) -> str:
    """A copy of examples/jobs/``name`` in ``tmp`` with "save": false and
    ``changes``."""
    with open(os.path.join(HERE, "examples", "jobs", name)) as f:
        spec = json.load(f)
    spec.update(save=False, **changes)
    if changes.get("method") == "LBFGS":
        spec["convergence"] = dict(spec["convergence"],
                                   conv_target=DRIVER_CONV_TARGET)
    path = os.path.join(tmp, f"{tag}_{name}")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def _run_cli(argv):
    """(exit code, standard output) of ``qoc_tpu_torch.cli.main(argv)``."""
    from qoc_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def phase_cli(dev) -> dict:
    """10a: ``python -m qoc_tpu_torch run`` (``cli.main``, no --device:
    the card) on the pi pulse, the CNOT and config 3, routed to kernel 3,
    and on the pi pulse with the native L-BFGS, routed to kernels 1-2
    (tree_backward == nfev); each must give the same bits as ``Grape``
    called directly on the job.  The pi pulse's run is traced with
    ``utils.profiling.trace`` (the segment kernel must be among the
    trace's device kernels); ``profiling.time_fn`` and ``memory_stats``
    read the pi pulse's lean loss; without a card (CUDA_VISIBLE_DEVICES
    empty) ``run`` exits non-zero with ``entry_device``'s message.
    Returns the launch counts' sums."""
    import tempfile

    import torch

    import qoc_tpu_torch as q
    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.utils import profiling
    from qoc_tpu_torch.utils.jobs import load_job

    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = os.path.join(tmp, "trace")
        for tag, (name, changes, kernels, want) in enumerate(CLI_RUNS):
            path = _cli_job(name, tmp, tag, changes)
            traced = tag == 0
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            with (profiling.trace(trace_dir) if traced
                  else contextlib.nullcontext()):
                rc, text = _run_cli(["run", path])
            wall = time.perf_counter() - t0
            launches = dict(_cuda.LAUNCHES)
            for kname, cnt in launches.items():
                totals[kname] += cnt
            got = json.loads(text.strip().splitlines()[-1])
            routed = [ln.split("engine: ", 1)[1] for ln in text.splitlines()
                      if ln.startswith("[qoc-tpu-torch] engine: ")]
            with contextlib.redirect_stdout(io.StringIO()):
                direct = q.Grape(**load_job(path), device=dev)
            same = (got["loss"] == direct.loss
                    and got["reg_loss"] == direct.reg_loss
                    and got["iterations"] == direct.iterations)
            fields = dict(job=name, changes=changes, rc=rc, engine=routed,
                          wall_s=wall, result=got, launches=launches,
                          same_bits_as_grape=same)
            ok = (rc == 0 and routed == [want] == [direct.engine] and same
                  and got["file_path"] is None
                  and np.isfinite(got["loss"])
                  and all(launches[k] >= 1 for k in kernels))
            if changes.get("method") == "LBFGS":
                segments = len(direct.history.iterations)
                fields.update(evaluations=direct.nfev, aux_forwards=segments)
                ok = (ok and launches["tree_backward"] == direct.nfev >= 1
                      and launches["tree_forward"] == direct.nfev + segments
                      and 1.0 - got["loss"] >= DRIVER_BAR)
            else:
                ok = ok and 1.0 - got["loss"] >= 0.99
            if traced:
                trace_file = os.path.join(trace_dir, "trace.json")
                seg = sorted({e["name"] for e in
                              profiling.kernel_events(trace_file)
                              if "mega_segment" in e["name"]})
                fields.update(trace_bytes=os.path.getsize(trace_file),
                              trace_segment_kernels=seg)
                ok = ok and bool(seg)
            _line("phase10a", **fields)
            if not ok:
                failures.append(
                    f"cli run of {name} {changes}: rc {rc}, routed to "
                    f"{routed} (want [{want!r}]), launches {launches} (want "
                    f"{kernels} >= 1), result {got} against Grape's loss "
                    f"{direct.loss!r}, reg_loss {direct.reg_loss!r}, "
                    f"iterations {direct.iterations}, fields {fields}")
            if traced:
                _, loss_fn = make_forward(direct.problem, lean=True,
                                          device=dev)
                u0 = torch.as_tensor(direct.problem.u0_base, device=dev)
                torch.cuda.reset_peak_memory_stats(dev)
                timing = profiling.time_fn(loss_fn, u0, iters=20, warmup=2)
                mem = profiling.memory_stats(dev)
                peak = mem["max_memory_allocated"]
                _line("phase10a_profiling", time_fn=timing,
                      max_memory_allocated=peak,
                      allocated_bytes_all_peak=mem["allocated_bytes.all.peak"])
                if not (all(np.isfinite(v) and v > 0
                            for v in timing.values()) and peak > 0):
                    failures.append(f"profiling: time_fn {timing}, "
                                    f"max_memory_allocated {peak}")
        # no card, no --device: run must fail loudly, not fall back
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "qoc_tpu_torch", "run",
             _cli_job("spin_pi.json", tmp, len(CLI_RUNS), {})],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        refused = (r.returncode != 0 and not r.stdout.strip()
                   and "torch sees no CUDA device" in r.stderr)
        _line("phase10a_no_card", rc=r.returncode, stderr=r.stderr.strip(),
              wall_s=time.perf_counter() - t0)
        if not refused:
            failures.append(f"run without a card: rc {r.returncode}, "
                            f"stdout {r.stdout!r}, stderr {r.stderr!r}")
    if failures:
        raise AssertionError("; ".join(failures))
    return totals


def _sweep_example():
    """examples/torch_05_pod_scale_sweep.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_05_pod_scale_sweep",
        os.path.join(HERE, "examples", "torch_05_pod_scale_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _c5_where_time_goes(ex, p, n_op, columns: int, dev) -> dict:
    """One float32 loss-and-gradient of ``columns`` seeds of config 5 (the
    per-iteration work of the xla-cols runner): its wall
    (``profiling.time_fn``, 2 calls after one), and from one traced call
    the device's busy time, the GEMMs' share of it and the kernel count;
    the bound is 2 x 400 x 2000 x columns FLOP a product, 2 x 1800
    products, at 67 TFLOP/s."""
    import tempfile

    import torch

    from qoc_tpu_torch.parallel.batch import init_seeds
    from qoc_tpu_torch.parallel.cols_batch import (chain_inputs,
                                                   make_xla_batched_loss)
    from qoc_tpu_torch.utils import profiling

    extra, deltas, _ = ex.detuning_channel(p, n_op, columns,
                                           C5_CUT["n_grid"])
    loss = make_xla_batched_loss(p, None, extra_channel_mats=extra,
                                 device=dev)
    u = init_seeds(p, columns, torch.Generator().manual_seed(0), dev)
    w = _on(dev, deltas)

    def loss_and_grad():
        ud = u.detach().requires_grad_(True)
        reg, _ = loss(ud, w)
        return torch.autograd.grad(reg.sum(), ud)

    timing = profiling.time_fn(loss_and_grad, iters=2, warmup=1)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            loss_and_grad()
        events = profiling.kernel_events(os.path.join(tmp, "trace.json"))
    busy_us = sum(e["dur"] for e in events)
    gemm_us = sum(e["dur"] for e in events if "gemm" in e["name"].lower())
    mats, _, order, scaling = chain_inputs(p, extra, dev)
    Kp, M = mats.shape[0], mats.shape[1]
    products = 2 * p.steps * (1 << scaling) * (order - 1)
    flops = 2.0 * M * Kp * M * columns * products
    ms = 1e3 * timing["mean_s"]
    return dict(columns=columns, ms=ms, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / 1e3 / ms,
                gemm_share_of_busy=gemm_us / max(busy_us, 1e-9),
                kernels=len(events), products=products, tflop=flops / 1e12,
                bound_ms=flops / PEAK_FLOPS * 1e3,
                achieved_tflops=flops / 1e12 / (ms / 1e3))


def phase_config5(dev) -> dict:
    """10b: BASELINE config 5 cut in depth only (dim 200, M = 400, T =
    200, the 64-point detuning grid as an extra channel, backend
    "xla-cols"; 512 seeds in one chunk, 25 iterations): where one
    iteration's time goes at 512 and 2048 columns (traced first, while
    the process is young), the float32 loss and gradient at iteration 0
    of C5_CHECK_SEEDS seeds against float64 of the same arithmetic on the
    card, then the run with its routing line, ms per iteration,
    seed-iterations/s, peak memory and best and median loss."""
    import torch

    from qoc_tpu_torch.parallel.batch import init_seeds
    from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss

    ex = _sweep_example()
    p, n_op = ex.build_dim200()
    traced = [_c5_where_time_goes(ex, p, n_op, columns, dev)
              for columns in C5_PROFILE_COLUMNS]
    for t in traced:
        _line("phase10b_where_time_goes", **t)
    extra, deltas, _ = ex.detuning_channel(p, n_op, C5_CHECK_SEEDS,
                                           C5_CUT["n_grid"])
    u = init_seeds(p, C5_CHECK_SEEDS, torch.Generator().manual_seed(0), dev)
    res = {}
    for dtype in (torch.float32, torch.float64):
        loss = make_xla_batched_loss(p, None, extra_channel_mats=extra,
                                     device=dev, dtype=dtype)
        ud = u.to(dtype).requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reg, _ = loss(ud, _on(dev, deltas))
        (g,) = torch.autograd.grad(reg.sum(), ud)
        torch.cuda.synchronize()
        res[dtype] = (reg.detach().double().cpu(), g.double().cpu(),
                      1e3 * (time.perf_counter() - t0))
    (r32, g32, ms32), (r64, g64, ms64) = res[torch.float32], res[torch.float64]
    loss_gap = float((r32 - r64).abs().max())
    grad_gap = float((g32 - g64).abs().max() / g64.abs().max())
    _line("phase10b_iteration0", seeds=C5_CHECK_SEEDS,
          reg_loss=r32.tolist(), loss_gap=loss_gap, loss_bar=C5_LOSS_BAR,
          grad_gap_rel=grad_gap, grad_bar=C5_GRAD_BAR,
          ms_float32=ms32, ms_float64=ms64)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = ex.run_full(device=dev, **C5_CUT)
    routed = [ln.split("batch backend: ", 1)[1]
              for ln in buf.getvalue().splitlines()
              if ln.startswith("[qoc-tpu-torch] batch backend: ")]
    ms_iter = rep["ms_per_chunk_iteration"][0]
    _line("phase10b", routed=routed, seeds=rep["n_seeds"],
          iterations=rep["iterations"], wall_s=rep["wall_s"],
          ms_per_iteration=ms_iter,
          seed_iters_per_sec=rep["seed_iters_per_sec"],
          peak_device_bytes=rep["peak_device_bytes"],
          best_loss=rep["best_loss"], median_loss=rep["median_loss"],
          iteration0_median_loss=float(r32.median()))
    ok = (routed == [XLA_COLS] and loss_gap <= C5_LOSS_BAR
          and all(t["device_busy_ms"] > 0 for t in traced)
          and grad_gap <= C5_GRAD_BAR
          and rep["iterations"] == C5_CUT["max_iterations"] + 1
          and np.isfinite(rep["best_loss"]) and np.isfinite(ms_iter)
          and 0.0 <= rep["best_loss"] <= rep["median_loss"]
          < float(r32.median()))
    if not ok:
        raise AssertionError(
            f"config 5 cut: routed {routed} (want [{XLA_COLS!r}]), "
            f"iteration-0 |d reg_loss| {loss_gap:.3e} (<= {C5_LOSS_BAR}), "
            f"max|dg| / max|g| {grad_gap:.3e} (<= {C5_GRAD_BAR}), "
            f"iterations {rep['iterations']}, best {rep['best_loss']}, "
            f"median {rep['median_loss']} (< iteration 0's "
            f"{float(r32.median())}), traced device busy ms "
            f"{[t['device_busy_ms'] for t in traced]} (> 0)")
    return rep


# ---- group 11: the distribution layer and remat in the batch layer ------

# the batched_grape_adam result fields 11a and 11d compare
RESULT_ARRAYS = ("losses", "reg_losses", "u_base", "converged")
# 11b: tests/test_distributed.py's pi pulse (T = 20) at 64 seeds
SHARD_SEEDS = 64
SHARD_CONV = {"rate": 0.05, "conv_target": 1e-2}
SHARD_STEPS = 40
# 11c: config 5 at full width, cut in depth to 3 iterations
C5_SHARD_SEEDS = 4096
C5_SHARD_ITERATIONS = 3
# 11d: two ranks of 256 seeds each must give 11a's one-process result
# within this (when not bit for bit)
RANKS_BAR = 1e-6
# 11e: config 4 on "xla" under torch.func with remat, phase 9d's bars
REMAT_SEEDS = 16
REMAT_ITERATIONS = 3


def _result_gap(a: dict, b: dict) -> float:
    """Largest difference between two batched_grape_adam results' arrays
    (inf when the iterations or converged flags differ)."""
    if (a["iterations"] != b["iterations"]
            or not np.array_equal(a["converged"], b["converged"])):
        return float("inf")
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                   - np.asarray(b[k], np.float64))))
               for k in RESULT_ARRAYS)


def _same_bits(a: dict, b: dict) -> bool:
    return a["iterations"] == b["iterations"] and all(
        np.array_equal(a[k], b[k]) for k in RESULT_ARRAYS)


def phase_mesh_of_one(dev, ex) -> dict:
    """11a: ``make_mesh()`` with no process group and no MASTER_ADDR (a
    world of one on NCCL), then qoc_tpu's run_quick through the example's
    ``--quick`` functions: 512 pi seeds through
    ``batched_grape_adam(mesh=...)`` (routed to kernel 6; launch counts
    reset just before and read just after), which must give the bits of
    the same call without ``mesh=``, and the detuning sweep through
    ``make_mega_batched_runner(mesh=...)``, 500 iterations.  Returns the
    one-process result (11d's reference)."""
    import torch

    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.parallel.batch import batched_grape_adam
    from qoc_tpu_torch.parallel.mesh import make_mesh

    env = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
           if k in os.environ]
    mesh = make_mesh()
    backend = torch.distributed.get_backend()
    _cuda.reset_launch_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = ex.quick_seeds(mesh, dev)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    route = printed.getvalue().strip()
    with contextlib.redirect_stdout(io.StringIO()):
        plain = batched_grape_adam(ex.pi_pulse(), ex.QUICK_SEEDS,
                                   convergence=ex.QUICK_CONV, seed=0,
                                   device=dev)
    same = _same_bits(res, plain)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = ex.quick_sweep(mesh, dev)
    sweep_wall = time.perf_counter() - t0
    sweep_launches = dict(_cuda.LAUNCHES)
    _line("phase11a", backend=backend, ranks=mesh.size(), env_set=env,
          route=route, seeds=ex.QUICK_SEEDS, iterations=res["iterations"],
          best_loss=res["best_loss"],
          converged=int(np.sum(res["converged"])), wall_s=wall,
          seed_iterations_per_s=ex.QUICK_SEEDS * res["iterations"] / wall,
          launches=launches, same_bits_as_no_mesh=same,
          gap_to_no_mesh=_result_gap(res, plain),
          sweep_iterations=ex.QUICK_SWEEP_ITERATIONS,
          sweep_best_loss=float(sweep.min()),
          sweep_worst_loss=float(sweep.max()), sweep_wall_s=sweep_wall,
          sweep_launches=sweep_launches)
    ok = (backend == "nccl" and mesh.size() == 1 and not env
          and route == BATCH_MEGA and launches["mega_batch_segment"] >= 1
          and same and sweep_launches["mega_batch_segment"] >= 1
          and sweep.shape == (ex.QUICK_SEEDS,)
          and bool(np.all(np.isfinite(sweep) & (sweep <= 1))))
    if not ok:
        raise AssertionError(
            f"mesh of one: backend {backend} (want nccl), ranks "
            f"{mesh.size()}, environment {env} (want none), routed {route!r}"
            f" (want {BATCH_MEGA!r}), launches {launches}, same bits as "
            f"without mesh= {same}, sweep launches {sweep_launches}, sweep "
            f"losses finite and <= 1 (1 - F in float32 may dip below 0): "
            f"{bool(np.all(np.isfinite(sweep) & (sweep <= 1)))}")
    return plain


def phase_shard_step(dev) -> None:
    """11b: ``make_shard_map_step`` on the pi pulse (T = 20, 64 seeds) on
    the mesh of one, two calls of 40 steps: finite statistics and a best
    loss that falls; ms per call."""
    import torch

    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.parallel.batch import init_seeds
    from qoc_tpu_torch.parallel.mesh import make_mesh
    from qoc_tpu_torch.parallel.shard import make_shard_map_step
    import qoc_tpu_torch as q
    from qoc_tpu_torch.models.system import ControlProblem

    p = ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 8.0, 20,
        [np.array([1, 0], dtype=complex)], state_transfer=True,
        maxA=[0.8, 0.8], seed=0)
    init, step = make_shard_map_step(
        p, ConvergenceSettings.from_dict(SHARD_CONV), make_mesh(),
        steps_per_call=SHARD_STEPS, device=dev)
    u, opt = init(init_seeds(p, SHARD_SEEDS, torch.Generator().manual_seed(0)))
    stats, ms = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        u, opt, st = step(u, opt)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        stats.append([float(v) for v in st])
    _line("phase11b", seeds=SHARD_SEEDS, steps_per_call=SHARD_STEPS,
          ms_per_call=ms, stats=[dict(zip(("best_loss", "mean_loss",
                                           "n_converged", "grad_norm"), s))
                                 for s in stats])
    if not (np.all(np.isfinite(stats)) and stats[1][0] < stats[0][0]):
        raise AssertionError(f"shard step: stats {stats} (finite, and the "
                             "best loss must fall)")


def phase_cols_sharded(dev, ex) -> None:
    """11c: config 5 at full width (dim 200, M = 400, T = 200, the
    detuning channel, 4096 seeds as one shard of 4096 columns) through
    ``make_xla_cols_sharded_runner`` on the mesh of one, 3 iterations,
    with qoc_tpu's remat (each time step recomputed in the backward pass)
    and without it (the same runner over ``make_xla_batched_loss(...,
    remat=False)``): losses within 1e-6 and u' within 1e-5 of each other;
    ms per iteration, peak device memory and seed-iterations/s of each."""
    from functools import partial
    from unittest import mock

    import torch

    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.parallel import cols_batch
    from qoc_tpu_torch.parallel.batch import init_seeds
    from qoc_tpu_torch.parallel.mesh import make_mesh

    p, n_op = ex.build_dim200()
    extra, deltas, _ = ex.detuning_channel(p, n_op, C5_SHARD_SEEDS, 64)
    u0 = init_seeds(p, C5_SHARD_SEEDS, torch.Generator().manual_seed(0),
                    dev)
    conv = ConvergenceSettings.from_dict({"rate": 0.06})
    mesh = make_mesh()
    runs = {}
    for remat in (True, False, True):
        loss = partial(cols_batch.make_xla_batched_loss, remat=remat)
        with mock.patch.object(cols_batch, "make_xla_batched_loss", loss):
            run = cols_batch.make_xla_cols_sharded_runner(
                p, conv, mesh, extra_channel_mats=extra, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        u, fids, regs = run(u0, C5_SHARD_ITERATIONS, extra_weights=deltas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.setdefault(remat, []).append(dict(
            u=u, fids=fids, regs=regs,
            ms_per_iteration=wall * 1e3 / C5_SHARD_ITERATIONS,
            peak_bytes=torch.cuda.max_memory_allocated() - base,
            seed_iterations_per_s=C5_SHARD_SEEDS * C5_SHARD_ITERATIONS
            / wall))
    on, off = runs[True][-1], runs[False][0]
    loss_gap = max(float((on[k] - off[k]).abs().max())
                   for k in ("fids", "regs"))
    u_gap = float((on["u"] - off["u"]).abs().max())
    fields = {}
    for remat, name in ((True, "remat"), (False, "no_remat")):
        for k in ("ms_per_iteration", "peak_bytes", "seed_iterations_per_s"):
            fields[f"{name}_{k}"] = [r[k] for r in runs[remat]]
    _line("phase11c", seeds=C5_SHARD_SEEDS, columns=C5_SHARD_SEEDS,
          dim=p.state_num, steps=p.steps, iterations=C5_SHARD_ITERATIONS,
          loss_gap=loss_gap, u_gap=u_gap,
          median_loss=float(on["fids"].median()), **fields)
    if not (loss_gap <= 1e-6 and u_gap <= 1e-5
            and bool(torch.isfinite(on["regs"]).all())
            and on["u"].shape == (C5_SHARD_SEEDS, p.ops_len, p.steps)):
        raise AssertionError(
            f"config 5 through the sharded runner: remat against none "
            f"losses {loss_gap:.3e} (<= 1e-6), u' {u_gap:.3e} (<= 1e-5)")


def phase_two_ranks(dev, want: dict) -> None:
    """11d: two ranks on the one card (NCCL refuses two ranks on one GPU:
    gloo, through ``init_distributed``), each its own process started as
    ``run_in_new_process`` starts one: ``batched_grape_adam(mesh=...)`` on
    the 512 pi seeds, 256 a rank on kernel 6.  Both ranks must return the
    same result, equal to 11a's one-process run (bit for bit, else within
    RANKS_BAR)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        procs = []
        for rank in range(2):
            code = "\n".join([
                "import sys", "import numpy as np",
                f"sys.path.insert(0, {HERE!r})", "import chip_smoke",
                "from qoc_tpu_torch.ops import _cuda",
                "from qoc_tpu_torch.parallel import mesh as tmesh",
                "tmesh.init_distributed(backend='gloo', world_size=2, "
                f"rank={rank}, init_method='file://{tmp}/rendezvous')",
                "mesh = tmesh.make_mesh()",
                "ex = chip_smoke._sweep_example()",
                "_cuda.reset_launch_counts()",
                f"res = ex.quick_seeds(mesh, {str(dev)!r})",
                f"np.savez('{tmp}/rank{rank}.npz', "
                "iterations=res['iterations'], local_seeds=mesh.size(), "
                "launches=_cuda.LAUNCHES['mega_batch_segment'], "
                "**{k: res[k] for k in chip_smoke.RESULT_ARRAYS})",
                "tmesh.dist.destroy_process_group()"])
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          cwd=HERE))
        t0 = time.perf_counter()
        codes = [p.wait(timeout=600) for p in procs]
        wall = time.perf_counter() - t0
        if any(codes):
            raise AssertionError(f"two ranks: exit codes {codes}")
        got = []
        for rank in range(2):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as z:
                got.append({k: z[k] for k in z.files})
        for g in got:
            g["iterations"] = int(g["iterations"])
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    agree = _same_bits(got[0], got[1])
    same = _same_bits(got[0], want)
    gap = _result_gap(got[0], want)
    _line("phase11d", backend="gloo", ranks=2, seeds_per_rank=256,
          wall_s=wall, iterations=got[0]["iterations"],
          launches_per_rank=[int(g["launches"]) for g in got],
          ranks_agree=agree, same_bits_as_one_process=same,
          gap_to_one_process=gap)
    if not (agree and gap <= RANKS_BAR
            and all(int(g["launches"]) >= 1 for g in got)):
        raise AssertionError(
            f"two ranks: agree {agree}, gap to one process {gap:.3e} (<= "
            f"{RANKS_BAR}), launches {[int(g['launches']) for g in got]}")


def phase_batch_remat(dev, job, p4) -> None:
    """11e: remat in the batch layer under torch.func on the card:
    ``make_batched_runner(backend="xla")`` on config 4 (16 seeds, 3
    iterations) with and without ``remat``, and one vmapped
    loss-and-gradient at the seeds' start (the runner's ``batch_metrics``):
    reg_loss rel 1e-5 and max|dg| <= 1e-4 max|g| (phase 9d's bars); peak
    device memory and wall of each."""
    import torch

    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.parallel.batch import init_seeds, make_batched_runner

    rc = job["reg_coeffs"]
    conv = ConvergenceSettings.from_dict(job["convergence"])
    u0 = init_seeds(p4, REMAT_SEEDS, torch.Generator().manual_seed(0), dev)
    out = {}
    for remat in (False, True):
        _, loss_fn = make_forward(p4, reg_coeffs=rc, engine="scan",
                                  lean=True, remat=remat, device=dev)

        def seed_loss(u):
            reg, res = loss_fn(u)
            return reg, res.loss

        metrics = torch.func.vmap(torch.func.grad_and_value(seed_loss,
                                                            has_aux=True))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        g, (reg, _) = metrics(u0)
        torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated() - base
        with contextlib.redirect_stdout(io.StringIO()):
            init, run = make_batched_runner(p4, conv, reg_coeffs=rc,
                                            remat=remat, backend="xla",
                                            device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s = run(init(u0), REMAT_ITERATIONS, None)
        torch.cuda.synchronize()
        out[remat] = dict(g=g, reg=reg, grad_peak=grad_peak, state=s,
                          wall=time.perf_counter() - t0,
                          peak=torch.cuda.max_memory_allocated() - base)
    on, off = out[True], out[False]
    reg_rel = float(((on["reg"] - off["reg"]).abs() / off["reg"].abs()).max())
    grad_rel = float((on["g"] - off["g"]).abs().max() / off["g"].abs().max())
    run_reg_rel = float(((on["state"].reg_loss - off["state"].reg_loss).abs()
                         / off["state"].reg_loss.abs()).max())
    _line("phase11e", problem="transmon_cavity", seeds=REMAT_SEEDS,
          iterations=REMAT_ITERATIONS, reg_loss_rel=reg_rel,
          grad_rel=grad_rel, run_reg_loss_rel=run_reg_rel,
          remat_wall_s=on["wall"], no_remat_wall_s=off["wall"],
          remat_peak_bytes=on["peak"], no_remat_peak_bytes=off["peak"],
          remat_grad_peak_bytes=on["grad_peak"],
          no_remat_grad_peak_bytes=off["grad_peak"])
    if not (reg_rel <= 1e-5 and grad_rel <= 1e-4 and run_reg_rel <= 1e-5
            and on["state"].iteration == REMAT_ITERATIONS):
        raise AssertionError(
            f"batch-layer remat on config 4: reg_loss rel {reg_rel:.3e} "
            f"(<= 1e-5), max|dg| / max|g| {grad_rel:.3e} (<= 1e-4), after "
            f"{REMAT_ITERATIONS} iterations reg_loss rel {run_reg_rel:.3e} "
            "(<= 1e-5)")


def phase_distribution(dev) -> None:
    """Group 11, in a process of its own (its NCCL world of one and the
    ranks it starts)."""
    t0 = time.perf_counter()
    ex = _sweep_example()
    want = phase_mesh_of_one(dev, ex)
    phase_shard_step(dev)
    phase_cols_sharded(dev, ex)
    phase_two_ranks(dev, want)
    job, p4 = _config4()
    phase_batch_remat(dev, job, p4)
    import torch

    torch.distributed.destroy_process_group()
    _line("phase11", wall_s=time.perf_counter() - t0)


def _expected_launches(quick: dict) -> dict:
    """Each bench_torch window's launches per timed window with
    ``--quick`` (``bench_torch.QUICK_ITERS``): the kernels of the route
    the card's ladders pick, and no other."""
    def every(key, *kernels):
        return {k: quick[key] for k in kernels}

    return {
        "pi_pulse_mega": {"mega_segment": 1},
        "pi_pulse_xla_tree": every("pi_pulse_xla_tree", "tree_forward",
                                   "tree_backward"),
        "batched_1024seed": {"mega_batch_segment": 1},
        "dim64_unitary": every("dim64_unitary", "expm_forward"),
        "dim200_cavity_128seed": {}, "dim200_cavity_64seed": {},
        "dim200_speedup_64seed": {},
        "dim200_single": every("dim200_single", "expm_forward"),
        "cavity_costs_dim24": every("cavity_costs_dim24", "expm_forward"),
        "cavity_costs_dim60": every("cavity_costs_dim60", "expm_forward"),
        "cnot_reg_batched_128seed": {"mega_batch_segment_costs": 1},
        "dim200_4096seed_grid": {},
        "leakage_fused": {"mega_segment_costs": 1},
        "leakage_xla": {}, "cpu_baseline_pi_pulse": {},
        "cpu_baseline_dim64": {},
        "batched_1024seed_chain": every("batched_1024seed_chain",
                                        "state_chain_forward",
                                        "state_chain_backward"),
    }


MEASURE_ITERATIONS = 200     # 12b


def phase_measurement(dev) -> None:
    """Group 12, in a process of its own: the measurement path.  12a every
    window of bench_torch.py with ``--quick`` (a finite, positive rate and
    exactly the launches of its route in each timed window); 12b
    ``make_throughput_runner`` on the pi pulse over the tree kernels, 200
    iterations under ``torch.cuda.set_sync_debug_mode("error")`` (no read
    from the card inside ``run_n``), the same u_base bits as
    ``make_segment_runner`` with convergence off; 12c the converging
    segment loop of ``wall_clock_to_fidelity`` ends below 1e-4."""
    import math

    import torch

    import bench_torch
    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.optim.adam import (init_adam_state,
                                          make_segment_runner,
                                          make_throughput_runner)

    t0 = time.perf_counter()
    report = bench_torch.run(dev, quick=True)
    want = _expected_launches(bench_torch.QUICK_ITERS)
    for name, w in report["windows"].items():
        rates_ok = all(math.isfinite(r) and r > 0 for r in w["runs"])
        if name == "wall_clock":
            launches_ok = all(set(x) == {"mega_segment"}
                              for x in w["launches"])
        else:
            launches_ok = all(x == want[name] for x in w["launches"])
        if not (rates_ok and launches_ok):
            raise AssertionError(
                f"12a window {name}: runs {w['runs']} (finite, > 0), "
                f"launches {w['launches']} (want {want.get(name)})")
        _line("phase12a", window=name, median=w["median"],
              spread=w["spread"], launches=w["launches"][0],
              wall_s=w.get("wall_s"))
    if set(report["windows"]) != set(bench_torch.CARD_WINDOWS):
        raise AssertionError(f"12a ran {sorted(report['windows'])}")
    print(json.dumps(report), flush=True)

    # 12b: the fixed-count runner queues its launches
    problem = bench_torch._problem()
    conv = bench_torch._conv(conv_target=-1.0, min_grad=-1.0)
    _, loss_fn = make_forward(problem, lean=True, engine="auto", device=dev)
    if loss_fn.resolved_engine != "tree":
        raise AssertionError(f"12b routed to {loss_fn.resolved_engine}")
    u0 = torch.as_tensor(np.asarray(problem.u0_base, np.float32),
                         device=dev)
    run_n = make_throughput_runner(loss_fn, conv)
    run_n(init_adam_state(u0, conv), 2)             # warm
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fast = run_n(init_adam_state(u0, conv), MEASURE_ITERATIONS)
        queued_s = time.perf_counter() - t1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = dict(_cuda.LAUNCHES)
    slow = make_segment_runner(loss_fn, conv)(init_adam_state(u0, conv),
                                              MEASURE_ITERATIONS)
    same = (torch.equal(fast.u_base, slow.u_base)
            and torch.equal(fast.m, slow.m) and torch.equal(fast.v, slow.v)
            and fast.lr == slow.lr
            and fast.iteration == slow.iteration == MEASURE_ITERATIONS)
    n = MEASURE_ITERATIONS
    if not (same and launches["tree_forward"] == n
            and launches["tree_backward"] == n):
        raise AssertionError(
            f"12b: throughput runner vs segment runner same bits {same}, "
            f"launches {launches} (want {n} of each tree kernel)")
    _line("phase12b", iterations=n, same_bits=same, queued_s=queued_s,
          run_s=run_s, iters_per_s=n / run_s,
          tree_forward=launches["tree_forward"],
          tree_backward=launches["tree_backward"])

    # 12c: wall clock to 1 - 1e-4 on kernel 3
    if not report["final_loss"] < 1e-4:
        raise AssertionError(f"12c: the segment loop ended at loss "
                             f"{report['final_loss']} (< 1e-4)")
    _line("phase12c", wall_s=report["wall_clock_to_1e-4_s"],
          final_loss=report["final_loss"],
          iterations=report["iterations_to_target"])
    _line("phase12", wall_s=time.perf_counter() - t0)


# ---- group 13: the example scripts, the on-card test lane and the scaling
# evidence -----------------------------------------------------------------

# 13a: each example through its main() on the card: (example, kernels that
# must launch during it, its routing line, its iteration budget (None: the
# original's), the bar on |fidelity_f64 - (1 - loss)|).  The bars: phase
# 4's on the pi pulse (the same problem and settings), GAP_CEILING on the
# segment kernel's costs runs, phase 8c's on config 4.  Example 04 is cut
# to 50 of its 2000 iterations: enough to show its main(), its arguments
# and its route; phase 8c runs config 4 through pscan for 2000 iterations
# against its bar on 1 - loss.
EXAMPLE04_ITERATIONS = 50
EXAMPLE_RUNS = [
    ("01_qubit_pi_pulse", ("mega_segment",), MEGA, None, 2e-6),
    ("02_cnot_gate", ("mega_segment_costs",),
     "mega (fused Adam segment CUDA kernel, penalties: dwdt, envelope)",
     None, GAP_CEILING),
    ("03_transmon_leakage", ("mega_segment_costs",), LEAKAGE, None,
     GAP_CEILING),
    ("04_transmon_cavity", ("expm_forward",), "pscan", EXAMPLE04_ITERATIONS,
     5e-5)]
# 13b: tests_gpu's tests (the 16 counterparts of tests_tpu's and the 13
# cases with no counterpart, test_spans_on_gpu.py's,
# test_fidelity_f64_on_gpu.py's and test_pscan_on_gpu.py's), and the one
# skip allowed (the card's machine has no h5py; resume on the card is
# phase 9b's)
LANE_TESTS = 34
LANE_SKIP = "test_grape_save_resume_roundtrip_on_gpu"
# 13c: tools/torch_scaling_evidence.py's modes on the card
SCALING_ARGV = ["--dispatch", "--collectives", "1", "--weak", "2",
                "--dryrun", "2"]
# the least efficiency at update_step 100: 100 iterations of 1024 seeds at
# T = 1000 (about 167 ms) against one segment's dispatch cost, which may
# take at most half a percent (about 0.8 ms)
EFFICIENCY_BAR = 99.5


def _load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(HERE, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> None:
    """13a: examples/torch_0[1-4]_*.py through their ``main()`` on the
    card (no device: the card), 01-03 at their full budgets, 04 cut to
    EXAMPLE04_ITERATIONS.  Launch counts are reset just before each run
    and read just after: the route's kernels must launch, the routing line
    must be the route's, the example's own JSON line must report the same
    launches, and 1 - loss must sit within the run's bar of its float64
    readout; the penalty runs must lower reg_loss from iteration 0."""
    import qoc_tpu_torch as q
    from qoc_tpu_torch.ops import _cuda

    real = q.Grape
    failures = []
    for name, kernels, route, budget, bar in EXAMPLE_RUNS:
        mod = _load_example(name)
        seen = []

        def spy(*args, **kwargs):
            seen.append((args, kwargs, real(*args, **kwargs)))
            return seen[-1][2]

        q.Grape = spy
        try:
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            summary = mod.main(max_iterations=budget)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        finally:
            q.Grape = real
        (args, kwargs, res), = seen
        gap = abs(res.fidelity_f64 - (1.0 - res.loss))
        fields = dict(example=name, engine=res.engine,
                      iterations=res.iterations, loss=res.loss,
                      one_minus_loss=1.0 - res.loss,
                      fidelity_f64=res.fidelity_f64, fidelity_f64_gap=gap,
                      gap_bar=bar, wall_s=wall, grape_wall_s=summary["wall_s"],
                      iters_per_s=res.iterations / summary["wall_s"],
                      launches=launches, card=summary["card"])
        ok = (res.engine == route and summary["launches"] == launches
              and all(launches.get(k, 0) >= 1 for k in kernels)
              and np.all(np.isfinite(res.uks)) and gap <= bar)
        if kwargs.get("reg_coeffs"):
            reg0 = _reg_loss_at_start({"kwargs": kwargs}, res.problem)
            fields["reg_loss_iteration_0"] = reg0
            fields["reg_loss"] = res.reg_loss
            ok = ok and res.reg_loss < reg0
        else:
            ok = ok and res.loss < kwargs["convergence"]["conv_target"]
        _line("phase13a", **fields)
        if not ok:
            failures.append(
                f"{name}: routed to {res.engine!r} (want {route!r}), "
                f"launches {launches} (want {kernels} >= 1; its line says "
                f"{summary['launches']}), |fidelity_f64 - (1 - loss)| "
                f"{gap:.3e} (<= {bar:.1e}), loss {res.loss:.3e}, reg_loss "
                f"{res.reg_loss:.4e} (below iteration 0's where penalised, "
                f"else loss below conv_target)")
    if failures:
        raise AssertionError("; ".join(failures))


def phase_gpu_lane() -> None:
    """13b: ``python -m pytest tests_gpu -q`` in a process of its own on
    the card: all LANE_TESTS tests pass, but for LANE_SKIP, which may skip
    only for want of h5py.  The line carries the gaps each test recorded
    against its oracles (its junit XML's properties)."""
    import tempfile
    import xml.etree.ElementTree as ET

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lane_") as tmp:
        xml = os.path.join(tmp, "lane.xml")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "tests_gpu", "-q", "-rs",
             "-p", "no:cacheprovider", f"--junitxml={xml}",
             "-o", "junit_family=xunit1"], cwd=HERE,
            capture_output=True, text=True, timeout=600,
            env={k: v for k, v in os.environ.items()
                 if k != "QOC_TPU_TORCH_TEST_DEVICE"})
        wall = time.perf_counter() - t0
        print(r.stdout[-4000:], flush=True)
        cases, gaps = {}, {}
        if os.path.exists(xml):
            for case in ET.parse(xml).getroot().iter("testcase"):
                outcome = "passed"
                for child in case:
                    if child.tag in ("failure", "error", "skipped"):
                        outcome = (child.tag, child.get("message", ""))
                        break
                cases[case.get("name")] = outcome
                gaps[case.get("name")] = {
                    q.get("name"): float(q.get("value"))
                    for q in case.iter("property")}
    passed = sorted(n for n, o in cases.items() if o == "passed")
    others = {n: o for n, o in cases.items() if o != "passed"}
    allowed = (set(others) <= {LANE_SKIP}
               and all(o[0] == "skipped" and "h5py" in o[1]
                       for o in others.values()))
    _line("phase13b", tests=len(cases), passed=len(passed),
          not_passed=others, wall_s=wall, exit_code=r.returncode,
          gaps=gaps)
    if not (len(cases) == LANE_TESTS and allowed and r.returncode == 0):
        raise AssertionError(
            f"13b: tests_gpu ran {len(cases)} tests (want {LANE_TESTS}), "
            f"exit code {r.returncode}, not passed {others} (only "
            f"{LANE_SKIP} may skip, for h5py); stderr {r.stderr[-2000:]}")


def phase_scaling_evidence() -> None:
    """13c: tools/torch_scaling_evidence.py on the card: the dispatch cost
    of kernel 6, its split and the efficiency at update_step 100 (at least
    EFFICIENCY_BAR), the collectives per segment of both sharded runners
    at a world of one on NCCL (none in the hot loop), weak-scaling identity
    on one and two gloo ranks on the one card (the tool exits 1 where the
    losses differ or the hot loop calls a collective), and the dry run's
    four mechanisms on two gloo ranks.  (Identity at 1-8 ranks,
    ``--weak 8``, takes a call of its own: about 8 s a rank process.)"""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join("tools", "torch_scaling_evidence.py"),
         *SCALING_ARGV], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        raise AssertionError(f"13c: exit code {r.returncode}: "
                             f"{r.stdout[-3000:]} {r.stderr[-3000:]}")
    rep = json.loads(lines[-1])
    d, c, w = rep["dispatch"], rep["collectives"], rep["weak_scaling"]
    oks = [x for x in lines if x.startswith("dryrun mechanism")
           and x.endswith(": ok")]
    checks = {
        "dispatch kernel 6": d["launches"].get("mega_batch_segment", 0) >= 1,
        "efficiency": (EFFICIENCY_BAR <= d["efficiency_update_step_100_pct"]
                       <= 100.0),
        "nccl world of one": c["ranks"] == 1 and c["backend"] == "nccl",
        "hot loop": all(c[k]["hot_loop"] == 0
                        for k in ("mega_batch", "xla_cols_dim200")),
        "collectives kernel 6": c["launches"].get("mega_batch_segment",
                                                  0) >= 1,
        "weak scaling": ([x["ranks"] for x in w["sizes"]] == [1, 2]
                         and all(x["losses_identical_to_1rank"]
                                 for x in w["sizes"])),
        "weak scaling kernel 6": all(
            x["launches"].get("mega_batch_segment", 0) >= 1
            for x in w["sizes"]),
        "dry run": len(oks) == 4 and rep["dryrun"]["ranks"] == 2,
        "dry run kernel 6": rep["dryrun"]["launches"].get(
            "mega_batch_segment", 0) >= 1,
    }
    _line("phase13c", card=rep["card"], wall_s=wall, dispatch=d,
          collectives=c, weak_scaling=w,
          dryrun={k: rep["dryrun"][k] for k in ("ranks", "backend",
                                                "launches")},
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"13c: {checks}")


def phase_programs() -> None:
    """Group 13, in a process of its own: 13a the example scripts, 13b the
    on-card test lane, 13c the scaling evidence."""
    t0 = time.perf_counter()
    phase_examples()
    phase_gpu_lane()
    phase_scaling_evidence()
    _line("phase13", wall_s=time.perf_counter() - t0)


def run_in_new_process(*calls: str) -> None:
    """Run ``calls`` (statements over this module, ``chip_smoke``, and
    ``dev``, the card) in a Python process of their own, which prints to this
    one's output.  On the card's machine torch.profiler loses device
    events a few minutes into a process (its GPU timestamps drift out of
    the profiled window: a traced 512 x 512 product lost its kernels
    after phases 2-7, the CLI run its segment kernel after phase 8a), so
    a group that traces runs early in a process of its own."""
    code = "\n".join(["import sys", "import torch",
                      f"sys.path.insert(0, {HERE!r})",
                      "import chip_smoke",
                      "dev = torch.device('cuda', 0)", *calls])
    sys.stdout.flush()
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"{'; '.join(calls)} in a new process exited "
                             f"with code {r.returncode}")


def _times(t: dict, prefix: str, ms_prefix: Optional[str] = None):
    """(ms, plain_ms, bound_ms, bound_by) of a phase's timing entry."""
    ms_prefix = prefix if ms_prefix is None else ms_prefix
    return (t[ms_prefix + "ms"], t[prefix + "plain_ms"],
            t[prefix + "bound_ms"], t[prefix + "bound_by"])


def _kernel(name: str, source: str, replaces: str, launches: dict,
            max_abs_err: float, ms: float, plain_ms: float, bound_ms: float,
            bound_by: str, library_ms: Optional[float] = None) -> dict:
    """One entry of the kernels line.  ``library_ms``: the time of the one
    PyTorch call that computes the kernel's function, where there is one:
    ``torch.linalg.matrix_exp`` for kernel 7, and for kernel 8's VJP the
    ``matrix_exp`` of the 2M block matrix that its backward runs (phase
    8a).  No single PyTorch call computes the others (chain
    products of truncated Taylor series, Adam segments): null."""
    return dict(name=name, route="cuda",
                source="qoc_tpu_torch/csrc/" + source,
                replaces="qoc_tpu/" + replaces, launches=launches[name],
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


GROUPS = ("2-4", "5-7", "8", "9", "10", "11", "12", "13")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(GROUPS),
                    help="comma-separated phase groups among "
                         f"{', '.join(GROUPS)} (default: all; phase 1 "
                         "always runs)")
    groups = ap.parse_args().phases.split(",")
    if not set(groups) <= set(GROUPS):
        ap.error(f"--phases takes groups among {GROUPS}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from qoc_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    build_s = time.perf_counter() - t0
    _line("phase1", card=smi, torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0],
          build_s=build_s, library=os.path.relpath(lib_path, HERE))

    kernels = []
    if "2-4" in groups:
        tree = phase_tree(dev)
        problems = _problems()
        mega = phase_mega(dev, {k: problems[k] for k in ("pi_pulse", "cnot")})
        costs = phase_mega_costs(dev, problems)
        launches = phase_grape(problems)
        pi_shape = tree["times"][(3, 4, 1000, 2, 0)]
        mega_err = max(m["u_err"] for m in mega.values())
        costs_err = max(m["u_err"] for m in costs.values())
        kernels += [
            _kernel("tree_forward", "tree_chain.cu", "ops/pallas_tree.py:284",
                    launches, tree["worst"]["tree_forward"],
                    *_times(pi_shape, "fwd_")),
            _kernel("tree_backward", "tree_chain.cu", "ops/pallas_tree.py:328",
                    launches, tree["worst"]["tree_backward"],
                    *_times(pi_shape, "bwd_")),
            _kernel("mega_segment", "mega.cu", "ops/pallas_mega.py:325",
                    launches, mega_err, *_times(mega["pi_pulse"], "", "seg_")),
            _kernel("mega_segment_costs", "mega_costs.cu",
                    "ops/pallas_mega.py:325", launches, costs_err,
                    *_times(costs["transmon_leakage"], "", "seg_")),
        ]
    if "5-7" in groups:
        problems = _problems()
        t0 = time.perf_counter()
        chain = phase_state_chain(dev, problems)
        batch = phase_mega_batch(dev, problems)
        batch_launches = phase_batch(dev, problems)
        _line("phases5to7", wall_s=time.perf_counter() - t0)
        pi_cols = chain["times"]["pi_pulse"]
        plain_err = max(batch[k]["u_err"] for k in BATCH_PLAIN)
        costs_err = max(v["u_err"] for k, v in batch.items()
                        if k not in BATCH_PLAIN)
        kernels += [
            _kernel("state_chain_forward", "state_chain.cu",
                    "ops/pallas_chain.py:115", batch_launches,
                    chain["worst"]["state_chain_forward"],
                    *_times(pi_cols, "fwd_")),
            _kernel("state_chain_backward", "state_chain.cu",
                    "ops/pallas_chain.py:220", batch_launches,
                    chain["worst"]["state_chain_backward"],
                    *_times(pi_cols, "bwd_")),
            _kernel("mega_batch_segment", "mega_batch.cu",
                    "parallel/pallas_mega_batch.py:567", batch_launches,
                    plain_err, *_times(batch["pi_pulse_sweep"], "", "seg_")),
            _kernel("mega_batch_segment_costs", "mega_batch_costs.cu",
                    "parallel/pallas_mega_batch.py:567", batch_launches,
                    costs_err,
                    *_times(batch["transmon_leakage"], "", "seg_")),
        ]
    if "8" in groups:
        t0 = time.perf_counter()
        job, p4 = _config4()
        expm = phase_expm(dev, p4)
        phase_engines(dev, job, p4)
        expm_launches = phase_config4(dev, job, p4)
        phase_torch_func(dev, job, p4)
        _line("phase8", wall_s=time.perf_counter() - t0)
        c4 = expm["times"]["config4"]
        kernels += [
            _kernel("expm_forward", "expm.cu", "ops/pallas_expm.py:147",
                    expm_launches, expm["worst"]["expm_forward"],
                    *_times(c4, "fwd_"), library_ms=c4["fwd_library_ms"]),
            _kernel("expm_backward", "expm.cu", "ops/pallas_expm.py:147",
                    expm_launches, expm["worst"]["expm_backward"],
                    *_times(c4, "bwd_"), library_ms=c4["bwd_library_ms"]),
        ]
    if "9" in groups:
        t0 = time.perf_counter()
        problems = _problems()
        phase_drivers(dev)
        job, p4 = _config4()
        phase_config4_lbfgsb(dev, job, p4)
        phase_resume(dev, problems)
        phase_reference(dev, problems)
        phase_remat_complex(dev, job, p4)
        _line("phase9", wall_s=time.perf_counter() - t0)
    if "10" in groups:
        t0 = time.perf_counter()
        run_in_new_process("chip_smoke.phase_cli(dev)",
                           "chip_smoke.phase_config5(dev)")
        _line("phase10", wall_s=time.perf_counter() - t0)
    if "11" in groups:
        run_in_new_process("chip_smoke.phase_distribution(dev)")
    if "12" in groups:
        run_in_new_process("chip_smoke.phase_measurement(dev)")
    if "13" in groups:
        run_in_new_process("chip_smoke.phase_programs()")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
