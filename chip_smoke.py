"""Smoke test of qoc_tpu_torch on one CUDA card (H100): build the kernels,
hold each against its plain torch version, then drive ``Grape`` end to end.

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
     Launch counts are reset just before each run and read just after.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits with code 2 and prints no result.
"""

from __future__ import annotations

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

    pi_shape = tree["times"][(3, 4, 1000, 2, 0)]
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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
