"""Time kernels 1-8 of qoc_tpu_torch on the card, at chip_smoke.py's
shapes, and compare two checkouts in turns.

    python3 tools/chain_kernel_bench.py [--root DIR]
    python3 tools/chain_kernel_bench.py --compare PARENT_DIR
    python3 tools/chain_kernel_bench.py --profile
    python3 tools/chain_kernel_bench.py --range
    python3 tools/chain_kernel_bench.py --sass PARENT_DIR

``--root`` names the checkout whose ``qoc_tpu_torch`` is timed (default:
this repository); its kernels are built into its own ``.torch_ext_build``.
The problems and inputs are those of this repository's chip_smoke.py
(phase 2: kernels 1 and 2, the tree chain's forward and backward, at its
four shapes, per call with CUDA events over the wrapper and as the
kernel's device time from ``torch.profiler``, and ``Grape`` on the pi
pulse with ``engine="tree"``, its wall seconds; phases 3 and 3b: kernel
3, the fused segment, 100 iterations of the pi
pulse, the CNOT (also with amplitude and dwdt penalties: the costs
instance at M = 8), config 3, the all-seven ladder and the state transfer,
per iteration, and ``Grape`` on config 3's job, 5000 iterations, its wall
seconds; phase 5: kernels 4 and 5, the state chain's forward and
backward, on its four column counts; phase 6: kernel 6, 20 iterations of
each of its six cases, timed as phase 6 times them).  Each shape prints
one line ``bench {...}``; a run ends with ptxas' registers and spills of
kernels 1-6 from the build log.

Each record also carries ``digest``, a hash of the kernel's outputs on
its inputs (kernels 7 and 8, the batched Taylor exponential and its
reverse, are timed and hashed at phase 8a's config-4 shape and at M =
256 with two squarings).

``--compare`` runs the timing four times, each in its own process, in the
order PARENT_DIR, this repository, this repository, PARENT_DIR, and prints
a last line ``compare {...}`` with both times of each version per shape
and, per shape, whether the two versions' outputs had the same bits.
Only CUDA-event times on one card are compared; the card's name and power
limit head the output.

``--profile`` traces phase 7's CNOT run (``batched_grape_adam``, 64 seeds,
200 iterations) with ``torch.profiler`` and prints a line ``profile
{...}``: the wall time, the device time summed over kernels, their ratio
(the device's busy share; one minus it is the idle share between
launches), and the kernels that took most of it.

``--range`` times kernels 1 and 2 against their plain versions over M
and T, up to the most steps ``tree_chain_supported`` admits for each M,
at order M / 2 + 2 without squaring, at order 20 with 16 squarings and
at order 0 (the first power kept) with one, and checks each against the
plain version; one line ``range {...}`` per shape.

``--sass`` compiles every kernel source of this repository and of
PARENT_DIR to a cubin with ``_cuda.NVCC_FLAGS`` and compares each kernel
function's machine code (``cuobjdump -sass``, addresses stripped); one
line ``sass {...}`` names the functions whose code differs and those
found on one side only.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np

HERE = str(Path(__file__).resolve().parents[1])


def _digest(*xs) -> str:
    """A hash of the bits of tensors, numbers and tuples of them."""
    import torch

    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(x, (tuple, list)):
            for y in x:
                add(y)
        elif isinstance(x, (int, float)):
            h.update(repr(x).encode())

    add(xs)
    return h.hexdigest()[:16]


def _tree_calls(_cuda, mats, wp, R, order: int, s: int):
    """(forward, backward) launches of kernels 1-2 for either interface:
    the backward takes the padded weights where its parameters name
    ``w`` (the segment design), else the parent's residuals alone."""
    import inspect

    res = _cuda.tree_forward(mats, wp, order, s)[1:]
    if "w" in inspect.signature(_cuda.tree_backward).parameters:
        res = (wp, *res)
    return (partial(_cuda.tree_forward, mats, wp, order, s),
            partial(_cuda.tree_backward, mats, *res, R, order, s))


def _tree(cs, dev, problems) -> list:
    """Kernels 1-2 at phase 2's shapes, per call, and Grape's wall on the
    pi pulse with engine="tree"."""
    import contextlib
    import io
    import time

    import torch

    import qoc_tpu_torch as q
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops.tree_chain import _pad_lanes

    rng = np.random.default_rng(0)
    recs = []
    for K, M, T, order, s in cs.TREE_SHAPES:
        mats = cs._on(dev, cs._generators(K, M, T, rng))
        w_h = rng.standard_normal((K, T)).astype(np.float32)
        w_h[0] = 1.0
        R = cs._on(dev, rng.standard_normal((M, M)).astype(np.float32))
        wp = _pad_lanes(cs._on(dev, w_h)).contiguous()
        shape = f"K{K}_M{M}_T{T}_o{order}_s{s}"
        for kernel, fn in zip(("tree_forward", "tree_backward"),
                              _tree_calls(_cuda, mats, wp, R, order, s)):
            recs.append(dict(kernel=kernel, shape=shape,
                             ms=cs._timed_ms(fn, 20),
                             device_ms=cs.device_ms(fn, kernel + "_kernel"),
                             digest=_digest(fn())))
    prob = problems["pi_pulse"]
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        res = q.Grape(*prob["args"], engine="tree", **prob["kwargs"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    recs.append(dict(kernel="grape_tree", shape="pi_pulse",
                     iterations=res.iterations, loss=res.loss, ms=wall * 1e3))
    return recs


def tree_range() -> None:
    """Kernels 1-2 against the plain version over M and T (``--range``)."""
    sys.path.insert(0, HERE)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from qoc_tpu_torch.ops import _cuda
    from qoc_tpu_torch.ops.tree_chain import (
        _pad_lanes, tree_chain_reference, tree_chain_supported)

    dev = torch.device("cuda", 0)
    _cuda.build()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    rng = np.random.default_rng(3)
    K = 3
    for M in _cuda.SUPPORTED_M:
        T_max = 2
        while tree_chain_supported(M, 2 * T_max):
            T_max *= 2
        Ts = sorted({t for t in (16, 128, 1000, T_max) if t <= T_max})
        for T in Ts:
            for order, s in ((M // 2 + 2, 0), (20, 16), (0, 1)):
                mats = cs._on(dev, cs._generators(K, M, T, rng))
                w_h = rng.standard_normal((K, T)).astype(np.float32)
                w_h[0] = 1.0
                R = cs._on(dev, rng.standard_normal((M, M))
                           .astype(np.float32))
                w = cs._on(dev, w_h).requires_grad_(True)
                wp = _pad_lanes(w.detach()).contiguous()
                fwd, bwd = _tree_calls(_cuda, mats, wp, R, order, s)
                E_r = tree_chain_reference(mats, w, order, s)
                (g_r,) = torch.autograd.grad(E_r, w, R, retain_graph=True)
                E_k = fwd()[0]
                g_k = bwd()[:, :T]
                print("range " + json.dumps(dict(
                    M=M, T=T, Tp=wp.shape[1], order=order, scaling=s,
                    geometry=_cuda.tree_geometry(M, wp.shape[1], K, order,
                                                 s)._asdict(),
                    fwd_rel=cs._rel(E_k, E_r), grad_rel=cs._rel(g_k, g_r),
                    fwd_ms=cs._timed_ms(fwd, 10),
                    fwd_plain_ms=cs._timed_ms(lambda: tree_chain_reference(
                        mats, w.detach(), order, s), 10),
                    bwd_ms=cs._timed_ms(bwd, 10),
                    bwd_plain_ms=cs._timed_ms(lambda: torch.autograd.grad(
                        E_r, w, R, retain_graph=True), 10))), flush=True)


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
        # the costs instance at M = 8 (pulse-shape penalties only)
        ("cnot_amplitude_dwdt", problems["cnot"],
         {"amplitude": 0.01, "dwdt": 0.001}, None),
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
                         ms_per_iter=ms / n,
                         digest=_digest(tuple(run(init(p.u0_base), n)))))
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        res = q.Grape(*leak["args"], engine="auto", **leak["kwargs"])
        wall = time.perf_counter() - t0
    recs.append(dict(kernel="grape", shape="transmon_leakage",
                     iterations=res.iterations, loss=res.loss, ms=wall * 1e3))
    return recs


def _expm(cs, dev) -> list:
    """Kernels 7 and 8 at config 4's shape (T = 1000, M = 120, Taylor
    order 14, no squaring) and at M = 256 (order 8, two squarings, T =
    64), on random generators of a near-unitary step."""
    import torch

    from qoc_tpu_torch.ops import _cuda

    rng = np.random.default_rng(8)
    recs = []
    for name, T, M, order, s in (("config4", 1000, 120, 14, 0),
                                 ("M256_s2", 64, 256, 8, 2)):
        A = cs._on(dev, (rng.standard_normal((T, M, M)) / (4 * np.sqrt(M)))
                   .astype(np.float32))
        Eb = cs._on(dev, rng.standard_normal((T, M, M)).astype(np.float32))
        for kernel, fn in (
                ("expm_forward", partial(_cuda.expm_forward, A, order, s)),
                ("expm_backward", partial(_cuda.expm_backward, A, Eb, order,
                                          s))):
            recs.append(dict(kernel=kernel, shape=name,
                             ms=cs._timed_ms(fn, 5), digest=_digest(fn())))
        del A, Eb
        torch.cuda.empty_cache()
    return recs


def run(root: str) -> list:
    """Time kernels 1-2 at phase 2's shapes, kernel 3 at phases 3-4's
    problems, kernels 4 and 5 at phase 5's shapes, kernel 6 at phase 6's
    cases and kernels 7-8 (``_expm``) with the checkout ``root``'s
    package; returns the records."""
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
    recs = _tree(cs, dev, problems) + _kernel3(cs, dev, problems)

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
        fwd = partial(_cuda.state_chain_forward, mats, w, p0, order, s)
        bwd = partial(_cuda.state_chain_backward, mats, w, traj, R, order, s)
        recs.append(dict(kernel="state_chain_forward", shape=name,
                         columns=C, ms=cs._timed_ms(fwd, 5),
                         digest=_digest(fwd())))
        recs.append(dict(kernel="state_chain_backward", shape=name,
                         columns=C, ms=cs._timed_ms(bwd, 5),
                         digest=_digest(bwd())))

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
                         seeds=S, ms_per_iter=ms / n,
                         digest=_digest(tuple(runner(init(u0), n,
                                                     extra_weights=ew)))))
    recs += _expm(cs, dev)
    for r in recs:
        print("bench " + json.dumps(r), flush=True)
    print("ptxas " + json.dumps(cs.ptxas_report(str(lib.parent
                                                    / "build.log"))),
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
    digests: dict = {}
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
                if "digest" in r:
                    digests.setdefault(f"{r['kernel']}:{r['shape']}",
                                       set()).add((tag, r["digest"]))
                t = r.get("ms", r.get("ms_per_iter"))
                table.setdefault(f"{r['kernel']}:{r['shape']}", {}).setdefault(
                    tag, []).append(t)
                if "device_ms" in r:
                    table.setdefault(f"{r['kernel']}:{r['shape']}:device",
                                     {}).setdefault(tag, []).append(
                                         r["device_ms"])
    same_bits = {k: len({d for _, d in v}) == 1 for k, v in digests.items()}
    print("compare " + json.dumps({"card": smi, "ms": table,
                                   "same_bits": same_bits}), flush=True)


def _sass(root: str, out: Path) -> dict:
    """Kernel function -> hash of its SASS, for every source of ``root``'s
    csrc (compiled in parallel into ``out``)."""
    sys.path.insert(0, HERE)
    from qoc_tpu_torch.ops import _cuda

    csrc = Path(root) / "qoc_tpu_torch" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    srcs = sorted(p.name for p in csrc.glob("*.cu"))
    procs = [subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-cubin", "-o",
         str(out / (src + ".cubin")), str(csrc / src)],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT) for src in srcs]
    if any(p.wait() for p in procs):
        raise SystemExit(f"nvcc failed on a source of {root}")
    cuobjdump = str(Path(_cuda._nvcc()).parent / "cuobjdump")
    funcs, name, body = {}, None, []
    for src in srcs:
        text = subprocess.run([cuobjdump, "-sass", str(out / (src + ".cubin"))],
                              capture_output=True, text=True,
                              check=True).stdout
        for line in text.splitlines() + ["Function : <end>"]:
            if "Function : " in line:
                if name is not None:
                    funcs[name] = hashlib.sha256(
                        "\n".join(body).encode()).hexdigest()[:16]
                name, body = line.split("Function : ")[1].strip(), []
            elif name is not None and "/*" in line:
                # the instruction and its encoding, without its address
                body.append(re.sub(r"^/\*[0-9a-f]+\*/", "", line.strip()))
    funcs.pop("<end>", None)
    return funcs


def sass_compare(parent: str) -> None:
    here = _sass(HERE, Path(HERE) / ".chipwork" / "sass" / "change")
    there = _sass(parent, Path(HERE) / ".chipwork" / "sass" / "parent")
    print("sass " + json.dumps(dict(
        same=sorted(k for k in here if there.get(k) == here[k]),
        differ=sorted(k for k in here if k in there and there[k] != here[k]),
        only_change=sorted(set(here) - set(there)),
        only_parent=sorted(set(there) - set(here)))), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--compare", metavar="PARENT_DIR")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--range", action="store_true")
    ap.add_argument("--sass", metavar="PARENT_DIR")
    a = ap.parse_args()
    if a.profile:
        profile()
    elif a.range:
        tree_range()
    elif a.sass:
        sass_compare(str(Path(a.sass).resolve()))
    elif a.compare:
        compare(str(Path(a.compare).resolve()))
    else:
        run(str(Path(a.root).resolve()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
