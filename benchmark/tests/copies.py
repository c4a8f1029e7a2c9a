"""Temporary copies of the benchmark with small cells, and runs of them
on the CPU in processes of their own (the port's plain versions)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness

REPO = harness.HERE.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())

SMALL_BATCH = {"generator": "batch_loop", "seeds": 4, "check_seeds": 3,
               "check_answers": 4, "trace_seconds": 1,
               "convergence": {"max_iterations": 6, "update_step": 4}}
SMALL_SINGLE = {"generator": "grape_loop", "check_answers": 3,
                "trace_seconds": 1,
                "convergence": {"max_iterations": 6, "update_step": 4}}
# four ranks of two seeds each, none frozen in the window (a target of 0),
# boundaries every two iterations
SMALL_BATCH_X4 = {"generator": "batch_loop", "seeds": 8, "check_seeds": 8,
                  "check_answers": 8, "trace_seconds": 1,
                  "convergence": {"max_iterations": 6, "update_step": 2,
                                  "conv_target": 0.0}}
SMALL_CELLS = {"small.restarts": ("transmon_leakage", "small_batch",
                                  "leakage.restarts"),
               "small.single": ("transmon_leakage", "small_single",
                                "leakage.single"),
               "smallmm.sweep": ("multimode_small", "small_batch",
                                 "multimode.sweep"),
               "smallmm.single": ("multimode_small", "small_single",
                                  "multimode.single"),
               "smallmm.sweep_x4": ("multimode_small", "small_batch_x4",
                                    "multimode.sweep_x4")}
# the small cells' chips, where not one
SMALL_CHIPS = {"smallmm.sweep_x4": 4}
# the answers' limit of the small four-rank cell, whose batches complete
# in the window (the cell it stands for completes none): the batch
# layer's (leakage.restarts)
SMALL_ANSWER_LIMIT = {"smallmm.sweep_x4": {"limit": 2e-4}}


def make_copy(dst: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder, with small cells added
    as files and entries only: two traffic files, a configuration of
    the multimode cavity with 3 cavity levels and 20 steps, and each
    small cell on the limits of the cell it stands for."""
    shutil.copytree(harness.HERE, dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads(json.dumps(BENCH))
    t = dst / "benchmark" / "traffic"
    (t / "small_batch.json").write_text(json.dumps(SMALL_BATCH))
    (t / "small_single.json").write_text(json.dumps(SMALL_SINGLE))
    (t / "small_batch_x4.json").write_text(json.dumps(SMALL_BATCH_X4))
    c = dst / "benchmark" / "configs"
    mm = json.loads((c / "multimode_cavity.json").read_text())
    mm.update(name="multimode_small", cavity_levels=3, steps=20,
              detuning_grid=4)
    (c / "multimode_small.json").write_text(json.dumps(mm))
    lim = dst / "benchmark" / "limits"
    for cell, (config, traffic, like) in SMALL_CELLS.items():
        b["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic,
                               "chips": SMALL_CHIPS.get(cell, 1), "why": "-"})
        if (lim / f"{like}.json").exists():
            limits = json.loads((lim / f"{like}.json").read_text())
            if cell in SMALL_ANSWER_LIMIT:
                limits["answer_gap"] = SMALL_ANSWER_LIMIT[cell]
            (lim / f"{cell}.json").write_text(json.dumps(limits))
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dst


def plant(root: Path, code: str) -> None:
    """Run ``code`` in every process of the copy at ``root`` that imports
    the benchmark (every rank of a run), before its first call."""
    with open(root / "benchmark" / "__init__.py", "a") as f:
        f.write("\n" + code + "\n")


def run_copy(root: Path, cell: str, seed: int = 987654321012,
             seconds: float = 2.0, patch: str = "", timeout: float = 900,
             trace: int = 0):
    """One run of ``cell`` from the copy at ``root`` on the CPU, in a
    process of its own (rank 0, where the cell takes more than one card);
    (exit code, last line's object, stderr)."""
    code = (f"import sys\nsys.path.insert(0, {str(root)!r})\n{patch}\n"
            "from benchmark import run\n"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
            "device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


