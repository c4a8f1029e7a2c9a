"""Time kernels 3-6 of qoc_tpu_torch on the card, at chip_smoke.py's
shapes, and compare two checkouts in turns.

    python3 tools/chain_kernel_bench.py [--root DIR]
    python3 tools/chain_kernel_bench.py --compare PARENT_DIR
    python3 tools/chain_kernel_bench.py --profile

``--root`` names the checkout whose ``qoc_tpu_torch`` is timed (default:
this repository); its kernels are built into its own ``.torch_ext_build``.
The problems and inputs are those of this repository's chip_smoke.py
(phases 3 and 3b: kernel 3, the fused segment, 100 iterations of the pi
pulse, the CNOT, config 3, the all-seven ladder and the state transfer,
per iteration, and ``Grape`` on config 3's job, 5000 iterations, its wall
seconds; phase 5: kernels 4 and 5, the state chain's forward and
backward, on its four column counts; phase 6: kernel 6, 20 iterations of
each of its six cases, timed as phase 6 times them).  Each shape prints
one line ``bench {...}``; a run ends with ptxas' registers and spills of
kernels 3-6 from the build log.

``--compare`` runs the timing four times, each in its own process, in the
order PARENT_DIR, this repository, this repository, PARENT_DIR, and prints
a last line ``compare {...}`` with both times of each version per shape.
Only CUDA-event times on one card are compared; the card's name and power
limit head the output.

``--profile`` traces phase 7's CNOT run (``batched_grape_adam``, 64 seeds,
200 iterations) with ``torch.profiler`` and prints a line ``profile
{...}``: the wall time, the device time summed over kernels, their ratio
(the device's busy share; one minus it is the idle share between
launches), and the kernels that took most of it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = str(Path(__file__).resolve().parents[1])


# the kernels whose ptxas report is read: a mangled-name pattern and the
# names of its template arguments (M, generator slots, costs flag)
_ENTRIES = (
    ("k3", r"mega_segment_kernelILi(\d+)ELb(\d)E", ("M", "costs")),
    ("k4", r"state_chain_forward_kernelILi(\d+)E(?:Li(\d+)E)?", ("M", "KG")),
    ("k5", r"state_chain_backward_kernelILi(\d+)E(?:Li(\d+)E)?", ("M", "KG")),
    ("k6", r"mega_batch_kernelILi(\d+)E(?:Li(\d+)E)?Lb(\d)E",
     ("M", "KG", "costs")),
)


def _ptxas(log_path: str) -> dict:
    """Registers and spill bytes of kernels 3-6 per instance."""
    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = None
                for tag, pat, args in _ENTRIES:
                    k = re.search(pat, m.group(1))
                    if k:
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


def _kernel3(cs, dev, problems) -> list:
    """Kernel 3 per iteration (100-iteration segments, timed as phases 3
    and 3b time them), and Grape's wall on config 3's job."""
    import contextlib
    import io
    import time

    import qoc_tpu_torch as q
    from qoc_tpu_torch.ops.mega import make_mega_segment_runner
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings

    n = 100
    leak = problems["transmon_leakage"]
    conv3 = ConvergenceSettings.from_dict(leak["kwargs"]["convergence"])
    cases = [
        ("pi_pulse", problems["pi_pulse"], None,
         problems["pi_pulse"]["kwargs"]["convergence"]),
        ("cnot", problems["cnot"], None,
         problems["cnot"]["kwargs"]["convergence"]),
        ("transmon_leakage", leak, leak["kwargs"]["reg_coeffs"], None),
        ("all_seven_unitary", cs._ladder(False), cs.ALL_SEVEN, None),
        ("state_speed_up_bandpass_forbidden", cs._ladder(True),
         cs.SPD_BP_FORB, None),
    ]
    recs = []
    for name, prob, rc, conv_d in cases:
        p = cs._build_problem(prob)
        conv = (conv3 if conv_d is None
                else ConvergenceSettings.from_dict(conv_d))
        init, run, _ = make_mega_segment_runner(
            p, conv, throughput=True, reg_coeffs=rc, device=dev)
        ms = cs._timed_ms(lambda: run(init(p.u0_base), n), 5)
        recs.append(dict(kernel="mega_segment" if rc is None
                         else "mega_segment_costs", shape=name,
                         ms_per_iter=ms / n))
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        res = q.Grape(*leak["args"], engine="auto", **leak["kwargs"])
        wall = time.perf_counter() - t0
    recs.append(dict(kernel="grape", shape="transmon_leakage",
                     iterations=res.iterations, loss=res.loss, ms=wall * 1e3))
    return recs


def run(root: str) -> list:
    """Time kernel 3 at phases 3-4's problems, kernels 4 and 5 at phase
    5's shapes and kernel 6 at phase 6's cases with the checkout
    ``root``'s package; returns the records."""
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.parallel.batch import init_seeds
    from qoc_tpu_torch.parallel.cols_batch import chain_inputs
    from qoc_tpu_torch.parallel.mega_batch import make_mega_batched_runner

    if str(Path(_cuda.__file__).resolve().parents[2]) != root:
        raise RuntimeError(f"{_cuda.__file__} is not under {root}")
    dev = torch.device("cuda", 0)
    lib = _cuda.build()
    problems = cs._problems()
    recs = _kernel3(cs, dev, problems)

    # phase 5: kernels 4 and 5
    rng = np.random.default_rng(1)
    cases = [("pi_pulse", cs._pi05(), 1024),
             ("cnot", cs._build_problem(problems["cnot"]), 256),
             ("transmon_leakage",
              cs._build_problem(problems["transmon_leakage"]), 128),
             ("pi_pulse_partial_block", cs._pi05(), 130)]
    for name, p, C in cases:
        mats, psi0, order, s = chain_inputs(p, device=dev)
        K, M, T = mats.shape[0], mats.shape[1], p.steps
        u = rng.standard_normal((T, K - 1, C)) / np.sqrt(T)
        w_h = np.ones((T, K, C), dtype=np.float32)
        w_h[:, 1:] = np.asarray(p.ops_max_amp)[None, :, None] * np.sin(u)
        w = cs._on(dev, w_h)
        p0 = psi0[:, np.arange(C) % psi0.shape[1]].contiguous()
        R = cs._on(dev, rng.standard_normal((M, C)).astype(np.float32))
        _, traj = _cuda.state_chain_forward(mats, w, p0, order, s)
        ms = cs._timed_ms(lambda: _cuda.state_chain_forward(
            mats, w, p0, order, s), 5)
        recs.append(dict(kernel="state_chain_forward", shape=name,
                         columns=C, ms=ms))
        ms = cs._timed_ms(lambda: _cuda.state_chain_backward(
            mats, w, traj, R, order, s), 5)
        recs.append(dict(kernel="state_chain_backward", shape=name,
                         columns=C, ms=ms))

    # phase 6: kernel 6, both instances
    n = 20
    pi = cs._pi05()
    sweep = cs._detuning_sweep(pi, 512)
    leak = problems["transmon_leakage"]["kwargs"]
    cnot_conv = problems["cnot"]["kwargs"]["convergence"]
    cases = [
        ("pi_pulse_sweep", pi, cs.PI05_CONV, None, 512, sweep),
        ("cnot", cs._build_problem(problems["cnot"]), cnot_conv, None, 64,
         None),
        ("transmon_leakage", cs._build_problem(problems["transmon_leakage"]),
         leak["convergence"], leak["reg_coeffs"], 64, None),
        ("all_seven_unitary", cs._build_problem(cs._ladder(False)),
         leak["convergence"], cs.ALL_SEVEN, 16, None),
        ("state_speed_up_bandpass_forbidden",
         cs._build_problem(cs._ladder(True)), leak["convergence"],
         cs.SPD_BP_FORB, 16, None),
        ("pi_pulse_sweep_frozen_at_10", pi,
         dict(cs.PI05_CONV, max_iterations=10), None, 512, sweep),
    ]
    for name, p, conv_d, rc, S, ex in cases:
        em, ew = ex if ex is not None else (None, None)
        init, runner, _ = make_mega_batched_runner(
            p, ConvergenceSettings.from_dict(conv_d), extra_channel_mats=em,
            reg_coeffs=rc, device=dev)
        u0 = init_seeds(p, S, torch.Generator().manual_seed(0), dev)
        ms = cs._timed_ms(lambda: runner(init(u0), n, extra_weights=ew), 2)
        recs.append(dict(kernel="mega_batch_segment" if rc is None
                         else "mega_batch_segment_costs", shape=name,
                         seeds=S, ms_per_iter=ms / n))
    for r in recs:
        print("bench " + json.dumps(r), flush=True)
    print("ptxas " + json.dumps(_ptxas(str(lib.parent / "build.log"))),
          flush=True)
    return recs


def profile() -> None:
    sys.path.insert(0, HERE)
    import time

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.parallel.batch import batched_grape_adam

    dev = torch.device("cuda", 0)
    _cuda.build()
    probs = cs._problems()
    p = cs._build_problem(probs["cnot"])
    conv = dict(probs["cnot"]["kwargs"]["convergence"], max_iterations=200)
    batched_grape_adam(p, 64, convergence=dict(conv, max_iterations=20),
                       seed=0, device=dev)   # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = batched_grape_adam(p, 64, convergence=conv, seed=0,
                                 device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            kernels[e.key] = us
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    print("profile " + json.dumps(dict(
        problem="cnot", seeds=64, iterations=res["iterations"], wall_s=wall,
        device_s=busy, busy_share=busy / wall,
        top_kernels_s={k[:80]: v / 1e6 for k, v in top})), flush=True)


def compare(parent: str) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    order = [("parent", parent), ("change", HERE), ("change", HERE),
             ("parent", parent)]
    table: dict = {}
    for tag, root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root],
            capture_output=True, text=True, timeout=1500)
        print(f"[{tag}] rc {proc.returncode}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], flush=True)
            raise SystemExit(1)
        for line in proc.stdout.splitlines():
            if line.startswith(("bench ", "ptxas ")):
                print(f"[{tag}] {line}", flush=True)
            if line.startswith("bench "):
                r = json.loads(line[6:])
                t = r.get("ms", r.get("ms_per_iter"))
                table.setdefault(f"{r['kernel']}:{r['shape']}", {}).setdefault(
                    tag, []).append(t)
    print("compare " + json.dumps({"card": smi, "ms": table}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--compare", metavar="PARENT_DIR")
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args()
    if a.profile:
        profile()
    elif a.compare:
        compare(str(Path(a.compare).resolve()))
    else:
        run(str(Path(a.root).resolve()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
