"""Smoke test of qoc_tpu_torch on one CUDA card (H100): build the kernels,
hold each against its plain torch version, then drive ``Grape`` and the
seed-batched layer end to end.

    python3 chip_smoke.py

Phases (each prints one line with its numbers; any failed check raises):

  1. the card (``nvidia-smi`` name and power limit), torch / CUDA versions,
     and the time to build the CUDA kernels from ``qoc_tpu_torch/csrc``;
  2. the tree chain kernels (forward and backward) against
     ``tree_chain_reference`` at four shapes, Tp up to 8192;
  3. the fused Adam segment kernel against ``mega_segment_reference``,
     100 iterations on the full-size pi pulse and CNOT problems;
  3b. the segment kernel's costs instance against ``mega_segment_reference``
     with the same penalties, 100 iterations on the transmon-leakage job
     (examples/jobs/transmon_leakage.json, BASELINE config 3), all seven
     penalties on a 3-level ladder (unitary, T=1000) and a state transfer
     with speed_up, bandpass and forbidden (T=1000);
  4. the main path: ``Grape`` on the pi pulse (examples/01_qubit_pi_pulse.py
     settings) and the CNOT (examples/jobs/cnot.json), ``engine="auto"``,
     which must route to the segment kernel and converge; the pi pulse
     with ``engine="tree"``, the per-iteration Adam over the tree kernels;
     and the transmon-leakage job, which must route to the costs instance.
     Launch counts are reset just before each run and read just after;
  5. the state chain kernels (forward and backward) against
     ``state_chain_reference`` at the pi pulse's, the CNOT's and config 3's
     shapes, and at 130 columns (a partial block);
  6. the fused batched-optimizer kernel (both instances) against
     ``mega_batch_segment_reference``, 20 iterations: the pi pulse at 512
     seeds with a detuning channel, the CNOT at 64 seeds, config 3 at 64
     seeds, the all-seven ladder and the speed_up/bandpass/forbidden state
     transfer at 16 seeds, and the pi sweep again with every seed frozen
     mid-segment;
  7. the batched main path: ``batched_grape_adam`` (``backend="auto"``,
     routed to kernel 6) on the pi pulse at 512 seeds
     (examples/05_pod_scale_sweep.py's first program, without its mesh),
     the CNOT and config 3 at 64 seeds, and ``backend="pallas"`` (kernels
     4 and 5) on the pi pulse at 256 seeds; launch counts as in phase 4.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

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


def phase_tree(dev) -> dict:
    """Kernels 1 and 2 against the plain version, forward and gradient."""
    import torch

    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops.tree_chain import (
        _pad_lanes, fused_tree_chain, tree_chain_reference)

    rng = np.random.default_rng(0)
    worst = {"tree_forward": 0.0, "tree_backward": 0.0}
    times = {}
    for K, M, T, order, s in [(3, 4, 1000, 2, 0), (6, 8, 1000, 3, 0),
                              (3, 12, 777, 6, 2), (3, 4, 5000, 2, 0)]:
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
        _, an, sq, tree = _cuda.tree_forward(mats, wp, order, s)
        reps = 20
        t = dict(
            fwd_ms=_timed_ms(lambda: _cuda.tree_forward(mats, wp, order, s),
                             reps),
            fwd_plain_ms=_timed_ms(
                lambda: tree_chain_reference(mats, w.detach(), order, s),
                reps),
            bwd_ms=_timed_ms(lambda: _cuda.tree_backward(
                mats, an, sq, tree, R, order, s), reps),
            bwd_plain_ms=_timed_ms(lambda: torch.autograd.grad(
                E_r, w, grad_outputs=R, retain_graph=True), reps),
        )
        times[(K, M, T, order, s)] = t
        _line("phase2", K=K, M=M, T=T, order=order, scaling=s,
              fwd_max_rel_err=fwd_rel, grad_max_rel_err=bwd_rel, **t)
    return {"worst": worst, "times": times}


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
    def cplx(x):
        if isinstance(x, dict):
            return np.asarray(x["real"], float) + 1j * np.asarray(x["imag"],
                                                                  float)
        return np.asarray(x, dtype=complex)

    def job(name):
        with open(os.path.join(HERE, "examples", "jobs", name)) as f:
            spec = json.load(f)
        kwargs = dict(convergence=spec["convergence"], maxA=spec["maxA"],
                      seed=spec["seed"], method=spec["method"],
                      show_plots=False, save=False)
        if "reg_coeffs" in spec:
            kwargs["reg_coeffs"] = spec["reg_coeffs"]
        return dict(
            args=(cplx(spec["H0"]), [cplx(h) for h in spec["Hops"]],
                  spec["Hnames"], cplx(spec["U"]), spec["total_time"],
                  spec["steps"], spec["states_concerned_list"]),
            kwargs=kwargs)

    return {"pi_pulse": pi, "cnot": job("cnot.json"),
            "transmon_leakage": job("transmon_leakage.json")}


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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                               init(p.u0_base), n, **statics)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(u_err=u_err, seg_ms=seg_ms, plain_ms=plain_ms)
        _line("phase3", problem=name, iterations=n, u_max_abs_err=u_err,
              u_tol=u_tol, u_plain_f32_vs_f64=floor, loss_abs_err=loss_err, unitary_scale_abs_err=us_err,
              loss_kernel=k.loss, loss_plain=r.loss,
              kernel_ms_per_iter=seg_ms / n, plain_ms_per_iter=plain_ms / n)
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mega_segment_reference(mats, psi0p, target, maxamp, u0rows,
                               init(p.u0_base), n, **statics)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(u_err=u_err, seg_ms=seg_ms, plain_ms=plain_ms)
        _line("phase3b", problem=name, reg_coeffs=sorted(rc), M=2 * p.state_num,
              T=p.steps, Tp=s0.u_base.shape[1], V=int(psi0p.shape[1]),
              trajectory=costs.traj, bins=int(costs.dftc.shape[1]),
              iterations=n, u_max_abs_err=u_err, u_tol=u_tol,
              u_plain_f32_vs_f64=floor, loss_abs_err=loss_err,
              reg_loss_abs_err=reg_err, reg_loss_tol=reg_tol,
              reg_loss_plain_f32_vs_f64=reg_floor,
              unitary_scale_abs_err=us_err, reg_loss_kernel=k.reg_loss,
              reg_loss_plain=r.reg_loss, kernel_ms_per_iter=seg_ms / n,
              plain_ms_per_iter=plain_ms / n)
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
        _, traj = _cuda.state_chain_forward(mats, wd, pd, order, s)
        t = dict(
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
        _line("phase5", problem=name, K=K, M=M, T=T, columns=C, order=order,
              scaling=s, fwd_max_rel_err=fwd_rel, grad_max_rel_err=bwd_rel,
              **t)
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
    from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss
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
        loss32 = make_xla_batched_loss(p, rc, em, device=dev)
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
            loss64 = make_xla_batched_loss(p, rc, em, device=dev,
                                           dtype=torch.float64)
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
        out[name] = dict(u_err=u_err, seg_ms=seg_ms, plain_ms=plain_ms)
        _line("phase6", problem=name, reg_coeffs=sorted(rc or {}),
              M=2 * p.state_num, T=p.steps, V=V, seeds=S, iterations=n,
              u_max_abs_err=u_err, u_tol=u_tol, u_plain_f32_vs_f64=floor,
              loss_max_abs_err=loss_err, reg_loss_max_abs_err=reg_err,
              reg_loss_tol=reg_tol, it_final=sorted(set(
                  k.it_cols[0].tolist())),
              kernel_ms_per_iter=seg_ms / n, plain_ms_per_iter=plain_ms / n)
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


def main() -> int:
    import torch

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

    tree = phase_tree(dev)
    problems = _problems()
    mega = phase_mega(dev, {k: problems[k] for k in ("pi_pulse", "cnot")})
    costs = phase_mega_costs(dev, problems)
    launches = phase_grape(problems)
    t0 = time.perf_counter()
    chain = phase_state_chain(dev, problems)
    batch = phase_mega_batch(dev, problems)
    batch_launches = phase_batch(dev, problems)
    _line("phases5to7", wall_s=time.perf_counter() - t0)

    pi_shape = tree["times"][(3, 4, 1000, 2, 0)]
    pi_cols = chain["times"]["pi_pulse"]
    kernels = [
        dict(name="tree_forward", route="cuda",
             source="qoc_tpu_torch/csrc/tree_chain.cu",
             replaces="qoc_tpu/ops/pallas_tree.py:284",
             launches=launches["tree_forward"],
             max_abs_err=tree["worst"]["tree_forward"],
             ms=pi_shape["fwd_ms"], plain_ms=pi_shape["fwd_plain_ms"]),
        dict(name="tree_backward", route="cuda",
             source="qoc_tpu_torch/csrc/tree_chain.cu",
             replaces="qoc_tpu/ops/pallas_tree.py:328",
             launches=launches["tree_backward"],
             max_abs_err=tree["worst"]["tree_backward"],
             ms=pi_shape["bwd_ms"], plain_ms=pi_shape["bwd_plain_ms"]),
        dict(name="mega_segment", route="cuda",
             source="qoc_tpu_torch/csrc/mega.cu",
             replaces="qoc_tpu/ops/pallas_mega.py:325",
             launches=launches["mega_segment"],
             max_abs_err=max(m["u_err"] for m in mega.values()),
             ms=mega["pi_pulse"]["seg_ms"],
             plain_ms=mega["pi_pulse"]["plain_ms"]),
        dict(name="mega_segment_costs", route="cuda",
             source="qoc_tpu_torch/csrc/mega_costs.cu",
             replaces="qoc_tpu/ops/pallas_mega.py:325",
             launches=launches["mega_segment_costs"],
             max_abs_err=max(m["u_err"] for m in costs.values()),
             ms=costs["transmon_leakage"]["seg_ms"],
             plain_ms=costs["transmon_leakage"]["plain_ms"]),
        dict(name="state_chain_forward", route="cuda",
             source="qoc_tpu_torch/csrc/state_chain.cu",
             replaces="qoc_tpu/ops/pallas_chain.py:115",
             launches=batch_launches["state_chain_forward"],
             max_abs_err=chain["worst"]["state_chain_forward"],
             ms=pi_cols["fwd_ms"], plain_ms=pi_cols["fwd_plain_ms"]),
        dict(name="state_chain_backward", route="cuda",
             source="qoc_tpu_torch/csrc/state_chain.cu",
             replaces="qoc_tpu/ops/pallas_chain.py:220",
             launches=batch_launches["state_chain_backward"],
             max_abs_err=chain["worst"]["state_chain_backward"],
             ms=pi_cols["bwd_ms"], plain_ms=pi_cols["bwd_plain_ms"]),
        dict(name="mega_batch_segment", route="cuda",
             source="qoc_tpu_torch/csrc/mega_batch.cu",
             replaces="qoc_tpu/parallel/pallas_mega_batch.py:567",
             launches=batch_launches["mega_batch_segment"],
             max_abs_err=max(batch[k]["u_err"] for k in BATCH_PLAIN),
             ms=batch["pi_pulse_sweep"]["seg_ms"],
             plain_ms=batch["pi_pulse_sweep"]["plain_ms"]),
        dict(name="mega_batch_segment_costs", route="cuda",
             source="qoc_tpu_torch/csrc/mega_batch_costs.cu",
             replaces="qoc_tpu/parallel/pallas_mega_batch.py:567",
             launches=batch_launches["mega_batch_segment_costs"],
             max_abs_err=max(v["u_err"] for k, v in batch.items()
                             if k not in BATCH_PLAIN),
             ms=batch["transmon_leakage"]["seg_ms"],
             plain_ms=batch["transmon_leakage"]["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
