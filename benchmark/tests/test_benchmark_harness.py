"""The harness on the CPU: the contract of BENCHMARK.json, the
configurations, the metric arithmetic on synthetic device intervals, the
look for JAX, and whole runs of small cells (the port's plain versions)
in a temporary copy of the benchmark, one of them added as data only."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, trace
from benchmark.trace import Event
from copies import SMALL_CELLS, make_copy, run_copy

REPO = harness.HERE.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).exists()
        assert set(c["reduced"]) <= set(json.loads(
            (REPO / c["file"]).read_text())["reduced"]) | set(c["reduced"])
    pairs = set()
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in names
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert moved, m["name"]
        for cell in m["workloads"]:
            assert cell in moved[0].get("workloads", cells), (m, cell)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert harness.metric_path(m["name"]).exists(), m["name"]
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_builds(name):
    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    s = harness.load_module(harness.HERE / "configs" / f"{name}.py",
                            "cfg_" + name).build(cfg)
    N = len(s["H0"])
    for h in [s["H0"]] + list(s["Hops"]) + list(s.get("extra_ops") or []):
        assert np.allclose(h, np.conj(h).T)
        assert np.shape(h) == (N, N)
    assert len(s["maxA"]) == len(s["Hops"]) == len(s["Hnames"])
    for key in cfg["reduced"]:
        assert key in cfg["source_values"]


def _synthetic():
    ev = [Event("k1", "device", 0, 10), Event("k2", "device", 5, 20),
          Event("k1", "device", 30, 40), Event("bench.solve", "host", 2, 45),
          Event("aten::foo", "host", 18, 32),
          Event("cudaLaunchKernel", "launch", 7, 8),
          Event("cudaMemcpyAsync", "launch", 12, 13),
          Event("bench.window", "host", 0, 50)]
    return SimpleNamespace(events=ev, lo=0, hi=50, iterations=3,
                           work={"flops": 3, "bytes": 1},
                           peak={"flops": 1e9, "bytes": 1e9},
                           peak_mem_bytes=3 * 2 ** 30)


def _read(name, ctx):
    return harness.load_module(harness.metric_path(name),
                               "m_" + name.replace(".", "_")).read(ctx)


def test_metric_arithmetic_on_synthetic_intervals():
    ctx = _synthetic()
    # busy: [0, 20] and [30, 40] of a 50 ns window
    assert trace.busy_ns(ctx.events, 0, 50) == 30
    assert _read("device_idle_pct.single", ctx) == pytest.approx(40.0)
    assert _read("launches_per_iter.batch", ctx) == pytest.approx(1.0)
    # least 3 ns an iteration against 10 ns busy an iteration
    assert _read("kernel_roofline_pct.single", ctx) == pytest.approx(30.0)
    assert _read("first_launch_ms.solve", ctx) == pytest.approx(5e-6)
    assert _read("peak_mem_gib.batch", ctx) == pytest.approx(3.0)
    b = trace.breakdown(ctx.events, 0, 50)
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "aten::foo": pytest.approx(10e-9),
        "bench.window": pytest.approx(10e-9)}
    assert trace.host_at([e for e in ctx.events if e.name != "bench.window"],
                         [45]) == [None]


def test_end_to_end_arithmetic():
    ctx = SimpleNamespace(setup_s=9.0, solve_walls=[0.1 * i for i in
                                                    range(1, 11)],
                          solve_iterations=[100] * 10, window_s=4.0,
                          seed_iterations=2000)
    assert _read("iters_per_s", ctx) == pytest.approx(1000 / 5.5)
    assert _read("seed_iters_per_s", ctx) == pytest.approx(500.0)
    assert _read("solve_ms.p90", ctx) == pytest.approx(910.0)
    assert _read("setup_s", ctx) == 9.0


def test_the_look_for_jax_compares_whole_top_level_names(monkeypatch):
    before = harness.banned_modules()
    for name in ("qoc_tpu_torch_fake.sub", "jaxtyping_fake", "flaxen",
                 "jax_fake"):
        monkeypatch.setitem(sys.modules, name, SimpleNamespace())
    assert harness.banned_modules() == before
    monkeypatch.setitem(sys.modules, "qoc_tpu.models.fake", SimpleNamespace())
    assert "qoc_tpu" in harness.banned_modules()


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_][\w.]*)", re.M)
    for path in harness.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {m.split(".")[0] for m in pat.findall(path.read_text())}
        assert not tops & set(harness.BANNED), path
        if "reference" in path.parts:
            assert "qoc_tpu_torch" not in tops, path


def test_seeds_are_reproducible_and_large():
    s = 2 ** 33 + 5
    assert harness.derive_seed(s, 1, 2) == harness.derive_seed(s, 1, 2)
    assert harness.derive_seed(s, 1, 2) != harness.derive_seed(s, 1, 3)
    assert 0 <= harness.derive_seed(s, 7) < 2 ** 63


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_each_generator_completes_a_window(copy_root, cell):
    rc, out, err = run_copy(copy_root, cell, seconds=4.0)
    assert rc == 0, err[-3000:]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    like = SMALL_CELLS[cell][2]
    want = {m["name"] for m in BENCH["end_to_end"]
            if like in m.get("workloads", [like])}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and UNIT.match(m["unit"])
    assert {"loss_gap", "step_gap"} <= set(out["checks"])
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)


COUNTED_LOOP = """
import time

from benchmark import harness

base = harness.load_module(harness.HERE / "generators" / "grape_loop.py",
                           "counted_base")


class Generator(base.Generator):
    \"\"\"A window of exactly two solves, whatever the seconds.\"\"\"

    def window(self, seconds):
        t0 = time.perf_counter()
        while self.calls < 2:
            rec = super().window(0.0)
        return dict(rec, window_s=time.perf_counter() - t0)
"""


def test_a_cell_a_generator_and_a_metric_added_as_data_only(tmp_path):
    root = make_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = root / "benchmark"
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.attempted / ctx.window_s\n")
    (bench / "generators" / "counted_loop.py").write_text(COUNTED_LOOP)
    (bench / "traffic" / "counted.json").write_text(json.dumps(dict(
        json.loads((bench / "traffic" / "small_single.json").read_text()),
        generator="counted_loop")))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "added.single", "config":
                           "multimode_small", "traffic": "counted",
                           "chips": 1, "why": "-"})
    b["end_to_end"].append({"name": "calls_per_s", "unit": "call/s",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["added.single"]})
    b["end_to_end"][-1]["name"] = "calls_per_s.counted"
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    rc, out, err = run_copy(root, "added.single")
    assert rc == 0, err[-3000:]
    assert set(out["metrics"]) == {"calls_per_s.counted", "setup_s"}
    assert out["attempted"] == 2
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_run_in_the_benchmark_alone_fails(tmp_path):
    """BENCHMARK.json and the benchmark's folder, without the program
    (and here without a card): no result, a code other than 0."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_a_run_that_loaded_the_jax_package_prints_no_result(copy_root):
    rc, out, err = run_copy(copy_root, "small.single", patch=(
        "import types\nsys.modules['qoc_tpu.fake'] = "
        "types.ModuleType('qoc_tpu.fake')"))
    assert rc == 1 and out is None
    assert "qoc_tpu" in err.strip().splitlines()[-1]
