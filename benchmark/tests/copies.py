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
SMALL_CELLS = {"small.restarts": ("transmon_leakage", "small_batch",
                                  "leakage.restarts"),
               "small.single": ("transmon_leakage", "small_single",
                                "leakage.single"),
               "smallmm.sweep": ("multimode_small", "small_batch",
                                 "multimode.sweep"),
               "smallmm.single": ("multimode_small", "small_single",
                                  "multimode.single")}


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
    c = dst / "benchmark" / "configs"
    mm = json.loads((c / "multimode_cavity.json").read_text())
    mm.update(name="multimode_small", cavity_levels=3, steps=20,
              detuning_grid=4)
    (c / "multimode_small.json").write_text(json.dumps(mm))
    lim = dst / "benchmark" / "limits"
    for cell, (config, traffic, like) in SMALL_CELLS.items():
        b["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1, "why": "-"})
        if (lim / f"{like}.json").exists():
            shutil.copy(lim / f"{like}.json", lim / f"{cell}.json")
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dst


def run_copy(root: Path, cell: str, seed: int = 987654321012,
             seconds: float = 2.0, patch: str = ""):
    """One run of ``cell`` from the copy at ``root`` on the CPU, in a
    process of its own; (exit code, last line's object, stderr)."""
    code = (f"import sys\nsys.path.insert(0, {str(root)!r})\n{patch}\n"
            "from benchmark import run\n"
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '0'], "
            "device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=900)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr


