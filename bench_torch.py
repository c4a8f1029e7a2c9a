"""Benchmark of qoc_tpu_torch on one CUDA card: the counterpart of
bench.py, window for window.

Prints ONE JSON line with bench.py's keys ({"metric", "value", "unit",
"vs_baseline", ...}) and, beside them, the card (``device``: the name
torch gives; ``card``: nvidia-smi's name and power limit), the torch and
CUDA versions, the host's CPU threads (the CPU baseline is the port's own
torch CPU path, not qoc_tpu's), ``quick``, and under ``windows`` each
window's median, spread, runs and the kernels it launched
(``launches``: the difference of ``ops._cuda.LAUNCHES`` over each timed
window).

Measurements (bench.py's, at its shapes and iteration counts):
  * single-problem iterations/s of the pi pulse (T = 1000) through the
    fused segment kernel, 30000 iterations in one launch, and through the
    per-iteration Adam over the tree kernels (``make_throughput_runner``:
    a fixed count, no convergence test, no read from the card);
  * wall clock to 1 - 1e-4 with the converging segment loop;
  * seed-iterations/s of 1024 pi seeds on the batched-optimizer kernel;
  * the dim-64 unitary, dim-24 and dim-60 (BASELINE config 4) transmon
    cavities, dim-200 single problem (pscan, kernel 7);
  * the dim-200 sweeps at 128 and 64 seeds and with speed_up, and the
    4096-seed detuning grid (``xla-cols``: cuBLAS GEMMs, no custom
    kernel);
  * the CNOT with dwdt + envelope on the batched kernel's costs instance;
  * the transmon-leakage job on the segment kernel's costs instance and
    on the scan engine;
  * the pi pulse and dim 64 on the host CPU (the port's torch CPU path);
  * 1024 pi seeds through the state chain kernels 4-5 (bench.py runs this
    one off the TPU only; the card runs it too).

Method (bench.py's): every window is timed ``REPEATS`` times after a
warm-up; the line reports the median and the relative spread
(max - min) / median.  Every window ends with ``torch.cuda.synchronize``
and a value fetch.  Where bench.py warms up with the window's full count
(jax compiles the loop for it), the per-iteration windows warm up with 3
iterations: eager torch compiles nothing per count.  The kernel windows
keep bench.py's warm-up (the first launch also builds the kernels).
Initial seeds come from a ``torch.Generator`` seeded as bench.py seeds
its PRNG keys: the bits differ from jax's, and the rates do not depend
on them (throughput mode disables freezing).

Run:  python bench_torch.py [--quick] [--only k1,k2] [--device cpu]

Without a card and without ``--device cpu`` it exits 2.  ``--device cpu``
runs bench.py's CPU branch (its windows only, on the plain torch
versions).  ``--quick`` cuts iteration counts only (warm-ups to one
iteration; the same T, M and widths; one 2048-column chunk of the grid)
and writes ``"quick": true``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "examples", "jobs"))

from qoc_tpu_torch import interop  # noqa: E402
from qoc_tpu_torch.models import dressed, gates, operators  # noqa: E402
from qoc_tpu_torch.models.system import ControlProblem  # noqa: E402
from qoc_tpu_torch.ops import _cuda  # noqa: E402
from qoc_tpu_torch.ops.isomorphism import c_to_r_mat  # noqa: E402
from qoc_tpu_torch.optim.convergence import ConvergenceSettings  # noqa: E402
from qoc_tpu_torch.utils import profiling  # noqa: E402
# config 4's system and constants (examples/jobs/torch_make_transmon_cavity.py)
from torch_make_transmon_cavity import (  # noqa: E402
    MAXA, STEPS, TOTAL_TIME, build_system)

REPEATS = 3
# warm-up iterations of the per-iteration windows (--quick: 1)
WARM = {False: 3, True: 1}

# the windows of each branch of bench.py's main (:684-757), in its order
CARD_WINDOWS = (
    "pi_pulse_mega", "pi_pulse_xla_tree", "wall_clock", "batched_1024seed",
    "dim64_unitary", "dim200_cavity_128seed", "dim200_cavity_64seed",
    "dim200_speedup_64seed", "dim200_single", "cavity_costs_dim24",
    "cavity_costs_dim60", "cnot_reg_batched_128seed",
    "dim200_4096seed_grid", "leakage_fused", "leakage_xla",
    "cpu_baseline_pi_pulse", "cpu_baseline_dim64", "batched_1024seed_chain")
CPU_WINDOWS = ("pi_pulse_scan", "wall_clock", "batched_1024seed",
               "dim64_unitary", "cavity_costs_dim24", "leakage_xla")

# --quick: iterations per window (bench.py's counts are the defaults of
# the functions below)
QUICK_ITERS = {
    "pi_pulse_mega": 300, "pi_pulse_xla_tree": 30, "pi_pulse_scan": 2,
    "batched_1024seed": 20, "dim64_unitary": 2, "dim200": 2,
    "dim200_single": 2, "cavity_costs_dim24": 1, "cavity_costs_dim60": 2,
    "cnot_reg_batched_128seed": 10, "dim200_4096seed_grid": 1,
    "leakage_fused": 300, "leakage_xla": 3, "cpu_baseline_pi_pulse": 3,
    "cpu_baseline_dim64": 1, "batched_1024seed_chain": 1}
QUICK_GRID_SEEDS = 2048       # one chunk
MEGA_ITERS = 30000            # pi_pulse_mega: iterations in its one launch


def _sync(x: torch.Tensor) -> float:
    """Wait for the card and fetch a scalar derived from ``x``: every
    timing ends with it (bench.py's honest end of a window)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(torch.sum(x).item())


def _launched(before: dict) -> dict:
    """The kernels launched since ``before`` (a copy of LAUNCHES)."""
    return {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
            if v != before[k]}


def _measure(window, units: float) -> dict:
    """Run ``window()`` (one timed measurement ending in a value fetch)
    REPEATS times: the median rate in units/s, the spread (max - min) /
    median, the runs, and each run's launches."""
    rates, launches = [], []
    for _ in range(REPEATS):
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        window()
        rates.append(units / (time.perf_counter() - t0))
        launches.append(_launched(before))
    med = statistics.median(rates)
    spread = (max(rates) - min(rates)) / med if med else 0.0
    return {"median": med, "spread": spread, "runs": rates,
            "launches": launches}


def _load_statement():
    """1-min loadavg + count of OTHER busy python processes: the honesty
    check for cross-run comparability (host load inflates the CPU
    baselines and the host-bound windows)."""
    la = os.getloadavg()[0]
    me = os.getpid()
    busy = 0
    try:
        out = subprocess.run(
            ["ps", "-eo", "pid,pcpu,comm"], capture_output=True, text=True,
            timeout=10).stdout
        for line in out.splitlines()[1:]:
            parts = line.split()
            if len(parts) >= 3 and "python" in parts[2]:
                if int(parts[0]) != me and float(parts[1]) > 20.0:
                    busy += 1
    except Exception:
        busy = -1
    return {"loadavg_1min": round(la, 2), "busy_python_procs": busy}


# ---------------------------------------------------------------------------
# the problems bench.py builds inline, one builder each
# ---------------------------------------------------------------------------


def _problem(steps=1000):
    """The qubit pi pulse (bench.py:92)."""
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex),
        [operators.SIGMA_X, operators.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, steps,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0,
    )


def _conv(**over):
    base = {"rate": 0.01, "update_step": 100, "max_iterations": 5000,
            "conv_target": 1e-4}
    base.update(over)
    return ConvergenceSettings.from_dict(base)


def _leakage_problem(steps=100, levels=5):
    """Flagship config (BASELINE config 3): transmon qudit X gate with
    forbidden leakage levels (bench.py:171)."""
    a = operators.annihilate(levels)
    H0 = 2 * np.pi * (-0.2) / 2 * (a.conj().T @ a.conj().T @ a @ a)
    return ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        gates.transmon_gate(operators.SIGMA_X, levels), 6.0, steps, [0, 1],
        maxA=[2.0, 2.0], seed=0,
    )


_LEAKAGE_RC = {"forbidden_coeff_list": [10.0, 10.0, 10.0],
               "states_forbidden_list": [2, 3, 4], "dwdt": 0.001}


def _dressed_transfer(H0, Hops, Hnames, total_time, steps, maxA):
    """Dressed |0> -> dressed |1> state transfer (bench.py:252-261,
    :295-304)."""
    w_c, v_c, dressed_id = dressed.get_dressed_info(H0)
    psi0 = v_c[:, dressed.get_state_index(0, dressed_id)]
    tgt = v_c[:, dressed.get_state_index(1, dressed_id)]
    return ControlProblem.build(
        H0, Hops, Hnames, [tgt], total_time, steps, [psi0],
        state_transfer=True,
        dressed_info={"eigenvectors": v_c, "eigenvalues": np.real(w_c),
                      "dressed_id": dressed_id, "is_dressed": True},
        maxA=maxA, seed=0,
    )


def _cavity_dim24_problem():
    """Transmon x cavity (Hilbert dim 24, M = 48), T = 800, with dwdt +
    bandpass + speed_up (bench.py:239-263).  Returns (problem, reg_coeffs)."""
    ql, cl = 3, 8
    aq = operators.annihilate(ql)
    ac = operators.annihilate(cl)
    Iq, Ic = np.eye(ql), np.eye(cl)
    nq = np.kron(aq.conj().T @ aq, Ic)
    nc = np.kron(Iq, ac.conj().T @ ac)
    kerr = np.kron(aq.conj().T @ aq.conj().T @ aq @ aq, Ic)
    coupling = np.kron(aq, Ic) @ np.kron(Iq, ac).conj().T
    coupling = coupling + coupling.conj().T
    H0 = (2 * np.pi * 3.9 * nq + 2 * np.pi * 4.5 * nc
          - 2 * np.pi * 0.1 * kerr + 2 * np.pi * 0.1 * coupling)
    Hops = [np.kron(aq + aq.conj().T, Ic),
            np.kron(1j * (aq - aq.conj().T), Ic)]
    problem = _dressed_transfer(H0, Hops, ["qx", "qy"], 20.0, 800,
                                [2 * np.pi * 0.3] * 2)
    rc = {"dwdt": 0.0001, "bandpass": 0.1, "band": [0.1, 10.0],
          "speed_up": 0.001}
    return problem, rc


def _cavity_dim60_problem():
    """BASELINE config 4 at spec (dim 60, M = 120, T = 1000) with dwdt +
    bandpass + speed_up (bench.py:276-306).  Returns (problem,
    reg_coeffs)."""
    H0, Hops, Hnames = build_system()
    problem = _dressed_transfer(H0, Hops, Hnames, TOTAL_TIME, STEPS,
                                [MAXA] * 4)
    rc = {"dwdt": 0.0001, "bandpass": 0.1, "band": [0.1, 10.0],
          "speed_up": 0.0001}
    return problem, rc


def _cnot_problem():
    """The CNOT (BASELINE config 2 class) with its dwdt + envelope costs
    (bench.py:330-342).  Returns (problem, reg_coeffs)."""
    CNOT = np.eye(4, dtype=complex)
    CNOT[2:, 2:] = [[0, 1], [1, 0]]
    XI = np.kron(operators.SIGMA_X, np.eye(2))
    IX = np.kron(np.eye(2), operators.SIGMA_X)
    ZZ = np.kron(operators.SIGMA_Z, operators.SIGMA_Z)
    problem = ControlProblem.build(
        np.zeros((4, 4), dtype=complex), [XI, IX, ZZ], ["xi", "ix", "zz"],
        CNOT, 10.0, 1000, [0, 1, 2, 3], maxA=[1.0] * 3, seed=0,
        Taylor_terms=[8, 2],
    )
    return problem, {"dwdt": 0.01, "envelope": 0.1}


def _dim200_problem():
    """Qubit x 100-level cavity (Hilbert dim 200, M = 400), T = 200: the
    system bench.py writes three times (:372-386, :432-446, :545-559).
    Returns (problem, the cavity number operator)."""
    Nc = 100
    a = np.kron(np.eye(2), np.diag(np.sqrt(np.arange(1, Nc)), 1))
    sm = np.kron(np.array([[0, 1], [0, 0]]), np.eye(Nc))
    H0 = (2 * np.pi * 0.1 * (a.conj().T @ a)
          + 2 * np.pi * 0.05 * (a.conj().T @ sm + a @ sm.conj().T))
    Hops = [sm + sm.conj().T, 1j * (sm - sm.conj().T), a + a.conj().T]
    psi0 = np.zeros(2 * Nc, complex)
    psi0[0] = 1
    tgt = np.zeros(2 * Nc, complex)
    tgt[Nc] = 1
    problem = ControlProblem.build(
        H0, Hops, ["x", "y", "c"], [tgt], 4.0, 200, [psi0],
        state_transfer=True, maxA=[2 * np.pi * 0.3] * 3, seed=0,
    )
    return problem, np.asarray(a.conj().T @ a)


def _dim64_problem():
    """Unitary GRAPE at Hilbert dim 64 (M = 128): 200 steps, 4 random
    Hermitian controls from numpy seed 0, Taylor order 8, 2 squarings
    (bench.py:507-521)."""
    N = 64
    rng = np.random.default_rng(0)

    def herm(n):
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (A + A.conj().T) / 20

    H0 = np.diag(np.arange(N)).astype(complex) * 0.1
    Hops = [herm(N) for _ in range(4)]
    U = np.eye(N, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    return ControlProblem.build(
        H0, Hops, ["a", "b", "c", "d"], U, 10.0, 200, [0, 1, 2, 3],
        maxA=[1.0] * 4, seed=0, Taylor_terms=[8, 2],
    )


# ---------------------------------------------------------------------------
# the windows
# ---------------------------------------------------------------------------


def _u0(problem, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(problem.u0_base, np.float32),
                           device=dev)


def _seeds(problem, n_seeds: int, key: int, dev) -> torch.Tensor:
    """[S, K, T] initial pulses from ``torch.Generator().manual_seed(key)``
    (bench.py: ``jax.random.PRNGKey(key)``)."""
    from qoc_tpu_torch.parallel.batch import init_seeds

    return init_seeds(problem, n_seeds, torch.Generator().manual_seed(key),
                      dev)


def _single_window(problem, dev, n_iters, engine="auto", reg_coeffs=None,
                   warm=WARM[False]):
    """Fixed-count single-problem Adam over ``make_forward``'s lean loss
    (``make_throughput_runner``): bench.py's ``iters_per_sec`` and its
    siblings."""
    from qoc_tpu_torch.models.forward import make_forward
    from qoc_tpu_torch.optim.adam import (init_adam_state,
                                          make_throughput_runner)

    conv = _conv()
    _, loss_fn = make_forward(problem, reg_coeffs, engine=engine, lean=True,
                              device=dev)
    run_n = make_throughput_runner(loss_fn, conv)
    s0 = init_adam_state(_u0(problem, dev), conv)
    _sync(run_n(s0, warm).u_base)
    return _measure(lambda: _sync(run_n(s0, n_iters).u_base), n_iters)


def iters_per_sec(dev, engine, n_iters=3000, warm=WARM[False]):
    """Steady-state single-problem throughput of the pi pulse."""
    return _single_window(_problem(), dev, n_iters, engine, warm=warm)


def iters_per_sec_mega(dev, n_iters=MEGA_ITERS):
    """The pi pulse through the fused segment kernel: the whole
    ``n_iters``-iteration Adam run is one launch of kernel 3."""
    from qoc_tpu_torch.ops.mega import make_mega_segment_runner

    problem = _problem()
    init_state, run_segment, _ = make_mega_segment_runner(
        problem, _conv(), throughput=True, device=dev)
    ms = init_state(problem.u0_base)
    _sync(run_segment(ms, n_iters).u_base)   # build + warm
    return _measure(lambda: _sync(run_segment(ms, n_iters).u_base), n_iters)


def _mega_batch_window(problem, dev, n_seeds, n_iters, reg_coeffs=None):
    from qoc_tpu_torch.parallel.mega_batch import (batched_mega_supported,
                                                   make_mega_batched_runner)

    if not batched_mega_supported(problem, reg_coeffs):
        raise ValueError("problem outside the batched kernel's scope")
    init_state, run_n, _ = make_mega_batched_runner(
        problem, _conv(), throughput=True, reg_coeffs=reg_coeffs,
        device=dev)
    st = run_n(init_state(_seeds(problem, n_seeds, 0, dev)), n_iters)
    _sync(st.losses)     # build + drain
    return _measure(lambda: _sync(run_n(st, n_iters).losses),
                    n_seeds * n_iters)


def batched_iters_per_sec_mega(dev, n_seeds=1024, n_iters=400):
    """Seed-iterations/s of the pi pulse on the batched-optimizer kernel
    (kernel 6): every seed's whole segment in one launch."""
    return _mega_batch_window(_problem(), dev, n_seeds, n_iters)


def cnot_reg_batched_seediters(dev, n_seeds=128, n_iters=60):
    """The CNOT with its smoothness + envelope costs on kernel 6's costs
    instance."""
    problem, rc = _cnot_problem()
    return _mega_batch_window(problem, dev, n_seeds, n_iters, rc)


def _batched_adam_run(batched_loss, conv):
    """``run_n(u, state, n, *extra)``: n iterations of the summed batched
    loss's gradient and the per-seed Adam, no seed frozen.  It mirrors
    bench.py's inline loop (the vmapped ``opt.update`` in a fori_loop),
    which carries the optimizer state across windows; the sharded
    runner of ``cols_batch`` starts each call from a fresh state and
    gathers over a mesh, so it is not used here."""
    from qoc_tpu_torch.optim.adam import batched_adam_update, decay_factor

    factor = decay_factor(conv)

    def run_n(u, st, n, *extra):
        frozen = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
        for _ in range(n):
            x = u.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(batched_loss(x, *extra)[0].sum(), x)
            u, st = batched_adam_update(u, st, g, frozen, factor)
        return u, st

    return run_n


def batched_iters_per_sec(dev, n_seeds=1024, n_iters=100, warm=5):
    """Seed-iterations/s of the pi pulse through the state chain kernels
    4-5 (``chain_batch``; bench.py's ``pallas_batch`` window)."""
    from qoc_tpu_torch.optim.adam import init_batch_adam
    from qoc_tpu_torch.parallel.chain_batch import make_pallas_batched_loss

    problem = _problem()
    conv = _conv()
    run_n = _batched_adam_run(make_pallas_batched_loss(problem, device=dev),
                              conv)
    u = _seeds(problem, n_seeds, 0, dev)
    st = init_batch_adam(u, conv)
    _sync(run_n(u, st, warm)[0])
    return _measure(lambda: _sync(run_n(u, st, n_iters)[0]),
                    n_seeds * n_iters)


def dim200_sweep_iters_per_sec(dev, n_seeds=64, n_iters=50,
                               reg_coeffs=None, warm=2):
    """BASELINE config 5 scale: the dim-200 seed batch through the
    column-batched torch chain (``cols_batch``, its default remat)."""
    from qoc_tpu_torch.optim.adam import init_batch_adam
    from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss

    problem, _ = _dim200_problem()
    conv = _conv()
    run_n = _batched_adam_run(
        make_xla_batched_loss(problem, reg_coeffs, device=dev), conv)
    u = _seeds(problem, n_seeds, 0, dev)
    st = init_batch_adam(u, conv)
    _sync(run_n(u, st, warm)[0])
    return _measure(lambda: _sync(run_n(u, st, n_iters)[0]),
                    n_seeds * n_iters)


def dim200_grid_4096_seediters(dev, n_seeds=4096, n_iters=20, chunk=2048,
                               warm=2):
    """BASELINE config 5 at spec: 4096 seeds x the detuning grid through
    ``cols_batch`` with the detuning as a constant extra channel, in
    chunks of ``chunk`` columns; the window covers every chunk."""
    from qoc_tpu_torch.optim.adam import init_batch_adam
    from qoc_tpu_torch.parallel.cols_batch import make_xla_batched_loss

    problem, n_op = _dim200_problem()
    extra = np.stack([c_to_r_mat(
        -1j * problem.dt * n_op)]).astype(np.float32)
    deltas = np.linspace(-0.1, 0.1, n_seeds)[:, None].astype(np.float32)
    conv = _conv()
    run_n = _batched_adam_run(
        make_xla_batched_loss(problem, extra_channel_mats=extra, device=dev),
        conv)
    chunks = []
    for c0 in range(0, n_seeds, chunk):
        c1 = min(c0 + chunk, n_seeds)
        u = _seeds(problem, c1 - c0, c0 // chunk, dev)
        chunks.append((u, init_batch_adam(u, conv),
                       torch.as_tensor(deltas[c0:c1], device=dev)))
    _sync(run_n(*chunks[0][:2], warm, chunks[0][2])[0])

    def all_chunks():
        return sum(_sync(run_n(u, st, n_iters, ew)[0])
                   for u, st, ew in chunks)

    return _measure(all_chunks, n_seeds * n_iters)


def leakage_iters_per_sec(dev, n_iters=3000, fused=True, warm=WARM[False]):
    """The transmon-leakage job: ``fused`` on the segment kernel's costs
    instance (forbidden levels + dwdt in the kernel), else the scan engine
    through the per-iteration runner."""
    problem = _leakage_problem()
    if not fused:
        return _single_window(problem, dev, n_iters, "scan", _LEAKAGE_RC,
                              warm)
    from qoc_tpu_torch.ops.mega import make_mega_segment_runner, mega_supported

    if not mega_supported(problem, _LEAKAGE_RC):
        raise ValueError("the leakage job is outside the segment kernel")
    init_state, run_segment, _ = make_mega_segment_runner(
        problem, _conv(), throughput=True, reg_coeffs=_LEAKAGE_RC,
        device=dev)
    ms = init_state(problem.u0_base)
    _sync(run_segment(ms, n_iters).u_base)
    return _measure(lambda: _sync(run_segment(ms, n_iters).u_base), n_iters)


def cavity_costs_iters_per_sec(dev, n_iters=200, warm=WARM[False]):
    """Dim 24 with dwdt + bandpass + speed_up (pscan on the card)."""
    problem, rc = _cavity_dim24_problem()
    return _single_window(problem, dev, n_iters, reg_coeffs=rc, warm=warm)


def cavity_dim60_iters_per_sec(dev, n_iters=150, warm=WARM[False]):
    """BASELINE config 4 at spec (pscan, kernel 7)."""
    problem, rc = _cavity_dim60_problem()
    return _single_window(problem, dev, n_iters, reg_coeffs=rc, warm=warm)


def dim200_single_iters_per_sec(dev, n_iters=60, warm=WARM[False]):
    """Single-problem dim-200 time-optimal transfer, speed_up + dwdt
    (pscan, M = 400, T = 200)."""
    problem, _ = _dim200_problem()
    return _single_window(problem, dev, n_iters,
                          reg_coeffs={"speed_up": 0.001, "dwdt": 0.0001},
                          warm=warm)


def dim64_iters_per_sec(dev, n_iters=240, warm=WARM[False]):
    """Unitary GRAPE at Hilbert dim 64 (pscan on the card)."""
    return _single_window(_dim64_problem(), dev, n_iters, warm=warm)


def wall_clock_to_fidelity(dev, engine, target=1e-4, warm_segment=True):
    """Wall clock (after the build) to loss < ``target`` with the real
    converging segment loop: ``engine="mega"``, the segment kernel
    ``Grape`` takes by default on the card, or a per-iteration engine.
    Returns (wall, spread, final loss, iterations, decomposition or None,
    launches of each run)."""
    problem = _problem()
    conv = _conv(conv_target=target)
    if engine == "mega":
        from qoc_tpu_torch.ops.mega import make_mega_segment_runner

        init_state, run_segment, _ = make_mega_segment_runner(
            problem, conv, device=dev)

        def start():
            return init_state(problem.u0_base)

        def advance(st):
            return run_segment(st, conv.update_step)
    else:
        from qoc_tpu_torch.models.forward import make_forward
        from qoc_tpu_torch.optim.adam import (init_adam_state,
                                              make_segment_runner)

        _, loss_fn = make_forward(problem, lean=True, engine=engine,
                                  device=dev)
        run_segment = make_segment_runner(loss_fn, conv)

        def start():
            return init_adam_state(_u0(problem, dev), conv)

        def advance(st):
            return run_segment(st, st.iteration + conv.update_step)

    _sync(run_segment(start(), 1).u_base)           # build + warm
    if warm_segment:
        _sync(advance(start()).u_base)

    def once():
        st = start()
        while True:
            st = advance(st)
            if st.done:
                break
        _sync(st.u_base)
        return st

    walls, launches, state = [], [], None
    for _ in range(REPEATS):
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        state = once()
        walls.append(time.perf_counter() - t0)
        launches.append(_launched(before))
    wall = statistics.median(walls)
    spread = (max(walls) - min(walls)) / wall if wall else 0.0
    decomp = None
    if engine == "mega":
        # the round trip of a fetch of a finished array, and the device
        # time of one launch running exactly iterations_to_target
        # iterations minus one round trip (bench.py:618-643)
        rts = []
        for _ in range(5):
            t0 = time.perf_counter()
            _sync(state.u_base)
            rts.append(time.perf_counter() - t0)
        rt = statistics.median(rts)
        n_hit = state.iteration
        _sync(run_segment(start(), n_hit).u_base)
        devs = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            _sync(run_segment(start(), n_hit).u_base)
            devs.append(time.perf_counter() - t0)
        device_s = max(statistics.median(devs) - rt, 0.0)
        decomp = {"wall_clock_device_s": device_s,
                  "wall_clock_dispatch_s": max(wall - device_s, 0.0),
                  "dispatch_roundtrip_s": rt}
    return (wall, spread, state.loss, state.iteration, decomp, launches,
            walls)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run(dev, quick: bool = False, only=None) -> dict:
    """Every window of ``dev``'s branch (or those of them named in
    ``only``); returns the JSON line's dict."""
    on_card = dev.type == "cuda"
    names = CARD_WINDOWS if on_card else CPU_WINDOWS
    only = set(names if only is None else only)
    interop.full_fp32_matmul()
    cpu = torch.device("cpu")
    load = _load_statement()

    def n(key, full):
        return QUICK_ITERS[key] if quick else full

    # warm-up iterations: bench.py's, or one under --quick
    w = {"warm": WARM[quick]}
    w2 = {"warm": 1} if quick else {}

    windows, out = {}, {}

    def rec(name, w):
        windows[name] = w
        return w["median"]

    if on_card:
        steps = {
            "pi_pulse_mega": lambda: iters_per_sec_mega(
                dev, n("pi_pulse_mega", MEGA_ITERS)),
            "pi_pulse_xla_tree": lambda: iters_per_sec(
                dev, "auto", n("pi_pulse_xla_tree", 3000), **w),
            "batched_1024seed": lambda: batched_iters_per_sec_mega(
                dev, n_iters=n("batched_1024seed", 400)),
            "dim64_unitary": lambda: dim64_iters_per_sec(
                dev, n("dim64_unitary", 240), **w),
            "dim200_cavity_128seed": lambda: dim200_sweep_iters_per_sec(
                dev, n_seeds=128, n_iters=n("dim200", 50), **w2),
            "dim200_cavity_64seed": lambda: dim200_sweep_iters_per_sec(
                dev, n_iters=n("dim200", 50), **w2),
            "dim200_speedup_64seed": lambda: dim200_sweep_iters_per_sec(
                dev, n_iters=n("dim200", 50),
                reg_coeffs={"speed_up": 0.001}, **w2),
            "dim200_single": lambda: dim200_single_iters_per_sec(
                dev, n("dim200_single", 60), **w),
            "cavity_costs_dim24": lambda: cavity_costs_iters_per_sec(
                dev, n("cavity_costs_dim24", 200), **w),
            "cavity_costs_dim60": lambda: cavity_dim60_iters_per_sec(
                dev, n("cavity_costs_dim60", 150), **w),
            "cnot_reg_batched_128seed": lambda: cnot_reg_batched_seediters(
                dev, n_iters=n("cnot_reg_batched_128seed", 60)),
            "dim200_4096seed_grid": lambda: dim200_grid_4096_seediters(
                dev, n_seeds=QUICK_GRID_SEEDS if quick else 4096,
                n_iters=n("dim200_4096seed_grid", 20), **w2),
            "leakage_fused": lambda: leakage_iters_per_sec(
                dev, n("leakage_fused", 3000), fused=True),
            "leakage_xla": lambda: leakage_iters_per_sec(
                dev, n("leakage_xla", 300), fused=False, **w),
            "cpu_baseline_pi_pulse": lambda: iters_per_sec(
                cpu, "scan", n("cpu_baseline_pi_pulse", 3000), **w),
            "cpu_baseline_dim64": lambda: dim64_iters_per_sec(
                cpu, n("cpu_baseline_dim64", 5), **w),
            "batched_1024seed_chain": lambda: batched_iters_per_sec(
                dev, n_iters=n("batched_1024seed_chain", 100), **w2),
        }
    else:
        steps = {
            "pi_pulse_scan": lambda: iters_per_sec(
                dev, "scan", n("pi_pulse_scan", 3000), **w),
            "batched_1024seed": lambda: batched_iters_per_sec(
                dev, n_iters=n("batched_1024seed_chain", 100), **w2),
            "dim64_unitary": lambda: dim64_iters_per_sec(
                dev, n("dim64_unitary", 240), **w),
            "cavity_costs_dim24": lambda: cavity_costs_iters_per_sec(
                dev, n("cavity_costs_dim24", 200), **w),
            "leakage_xla": lambda: leakage_iters_per_sec(
                dev, n("leakage_xla", 300), fused=False, **w),
        }
    med = {}
    for name in names:
        if name not in only:
            continue
        if name == "wall_clock":
            wall, spread, loss, iters, decomp, launches, walls = (
                wall_clock_to_fidelity(dev, "mega" if on_card else "scan",
                                       warm_segment=not quick))
            windows["wall_clock"] = {"median": wall, "spread": spread,
                                     "runs": walls, "launches": launches}
            out.update({"wall_clock_to_1e-4_s": wall,
                        "wall_clock_spread": spread, **(decomp or {}),
                        "final_loss": loss, "iterations_to_target": iters})
            continue
        t0 = time.perf_counter()
        med[name] = rec(name, steps[name]())
        windows[name]["wall_s"] = time.perf_counter() - t0
        print(f"[bench_torch] {name}: {med[name]:.6g} "
              f"({windows[name]['wall_s']:.1f} s)", file=sys.stderr,
              flush=True)

    def get(name):
        return med.get(name)

    def ratio(a, b):
        return None if a is None or b is None else a / b

    ips = get("pi_pulse_mega" if on_card else "pi_pulse_scan")
    xla_ips = get("pi_pulse_xla_tree") if on_card else ips
    cpu_ips = get("cpu_baseline_pi_pulse") if on_card else ips
    leak = get("leakage_fused") if on_card else get("leakage_xla")
    d64 = get("dim64_unitary")
    report = {
        "metric": "GRAPE iterations/sec/card (qubit pi pulse, 1000 steps)",
        "value": ips,
        "unit": "iters/sec",
        "vs_baseline": ratio(ips, cpu_ips) if on_card else 1.0,
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "card": profiling.card(dev),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cpu_threads": {"torch": torch.get_num_threads(),
                        "os": os.cpu_count()},
        "quick": quick,
        "cpu_iters_per_sec": cpu_ips,
        "xla_tree_iters_per_sec": xla_ips,
        "batched_1024seed_iters_per_sec": get("batched_1024seed"),
        "batched_1024seed_chain_iters_per_sec": get("batched_1024seed_chain"),
        "dim64_unitary_iters_per_sec": d64,
        "dim64_vs_cpu": (ratio(d64, get("cpu_baseline_dim64"))
                         if on_card else 1.0),
        "dim200_cavity_128seed_iters_per_sec": get("dim200_cavity_128seed"),
        "dim200_cavity_64seed_iters_per_sec": get("dim200_cavity_64seed"),
        "dim200_speedup_64seed_iters_per_sec": get("dim200_speedup_64seed"),
        "dim200_single_iters_per_sec": get("dim200_single"),
        "dim200_4096seed_grid_seediters_per_sec": get("dim200_4096seed_grid"),
        "cavity_costs_dim60_iters_per_sec": get("cavity_costs_dim60"),
        "cavity_costs_dim24_iters_per_sec": get("cavity_costs_dim24"),
        "cnot_reg_batched_seediters_per_sec": get("cnot_reg_batched_128seed"),
        "leakage_transmon_iters_per_sec": leak,
        "leakage_transmon_xla_iters_per_sec": get("leakage_xla"),
        **out,
        "repeats": REPEATS,
        "load": load,
        "windows": windows,
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs bench.py's CPU branch (default: the card)")
    ap.add_argument("--quick", action="store_true",
                    help="cut iteration counts only (same shapes)")
    ap.add_argument("--only", default=None,
                    help="comma-separated windows to run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: torch sees no CUDA device; pass --device cpu "
              "to run bench.py's CPU branch on the plain torch versions",
              file=sys.stderr)
        return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" else \
        torch.device("cpu")
    only = None if args.only is None else args.only.split(",")
    names = CARD_WINDOWS if dev.type == "cuda" else CPU_WINDOWS
    if only is not None and not set(only) <= set(names):
        ap.error(f"--only takes windows among {', '.join(names)}")
    t0 = time.perf_counter()
    report = run(dev, args.quick, only)
    report["total_wall_s"] = time.perf_counter() - t0
    if not all(v is None or math.isfinite(v) for v in report.values()
               if isinstance(v, float)):
        print(json.dumps(report), flush=True)
        print("bench_torch: a rate is not finite", file=sys.stderr)
        return 1
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
