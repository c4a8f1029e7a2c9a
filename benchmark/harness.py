"""What every run of the benchmark shares: finding a cell's files by the
names in ``BENCHMARK.json``, the seeds drawn from ``--seed``, the sink
that keeps the program's routing lines, and the look for JAX.

A cell names a configuration (``configs/<name>.json`` and the file
``configs/<system>.py`` that makes its matrices), a traffic mix
(``traffic/<name>.json``, driven by the class ``Generator`` of
``generators/<generator>.py``) and, by its own name, the limits of its
comparison and the settings of its check call (``limits/<cell>.json``).
Each metric is read by ``metrics/<name>.py``, or, where no such file
exists, by the file of the name with its last dotted part taken off
(``device_idle_pct.single`` and ``device_idle_pct.batch`` share
``device_idle_pct.py``).  A system file may also return ``grape_kwargs``,
further keywords of the program's entries.  Adding any of these is
adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import io
import json
import os
import platform
import subprocess
import sys
from pathlib import Path
from types import ModuleType

import torch

HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "qoc_tpu")
ROUTE_PREFIX = "[qoc-tpu-torch]"


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as a module of its own (metric files have
    dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    bench: dict            # BENCHMARK.json
    workload: dict         # its entry in "workloads"
    config: dict           # configs/<config>.json
    system: dict           # the matrices its system file makes
    traffic: dict          # traffic/<traffic>.json
    limits: dict           # limits/<cell>.json ({} before it is set)

    def conv(self, **override) -> dict:
        """The configuration's Adam settings, with the traffic's and the
        call's overrides."""
        c = {k: self.config[k] for k in ("rate", "update_step",
                                          "max_iterations", "conv_target")}
        c.update(self.traffic.get("convergence", {}))
        c.update(override)
        return c

    def check_conv(self, steps: int) -> dict:
        """The check call's Adam settings: the window's, cut to ``steps``
        iterations (so that one segment holds them all), with the
        cell's ``check_convergence`` (a short learning-rate decay and a
        target that the seeds' losses straddle)."""
        return self.conv(max_iterations=steps,
                         **self.limits.get("check_convergence", {}))

    def generator(self, device, seed: int, ranks=None):
        """The traffic's generator for a run of this cell; ``ranks``: this
        process's rank of a cell on more than one card
        (``benchmark/ranks.py``), which only a generator that takes a
        mesh accepts."""
        name = self.traffic["generator"]
        mod = load_module(HERE / "generators" / f"{name}.py",
                          "benchmark_generator_" + name)
        if ranks is None or ranks.world == 1:
            return mod.Generator(self, device, seed)
        return mod.Generator(self, device, seed, ranks=ranks)

    def metrics(self, trace: bool) -> list:
        """The metrics this cell reports: the end-to-end ones with
        ``--trace 0``, the per-layer ones with ``--trace 1``."""
        out = []
        for m in self.bench["per_layer" if trace else "end_to_end"]:
            cells = m.get("workloads")
            if cells is None and trace:
                cells = [w["name"] for w in self.bench["workloads"]
                         if _reports(self.bench, w["name"], m["moves"])]
            if cells is None or self.name in cells:
                out.append(m)
        return out

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(metric_path(name),
                           "benchmark_metric_" + name.replace(".", "_"))


def metric_path(name: str) -> Path:
    """The file that reads the metric ``name``: ``metrics/<name>.py``,
    else the same with the name's last dotted part taken off, and so
    on."""
    stem = name
    while True:
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists() or "." not in stem:
            return path
        stem = stem.rsplit(".", 1)[0]


def _reports(bench: dict, cell: str, metric: str) -> bool:
    for m in bench["end_to_end"]:
        if m["name"] == metric:
            return m.get("workloads") is None or cell in m["workloads"]
    return False


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` beside the benchmark's
    folder, with its files."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    maker = load_module(
        HERE / "configs" / f"{config.get('system', w['config'])}.py",
        "benchmark_config_" + w["config"])
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = HERE / "limits" / f"{name}.json"
    limits = (json.loads(limits_path.read_text()) if limits_path.exists()
              else {})
    return Cell(name=name, bench=bench, workload=w, config=config,
                system=maker.build(config), traffic=traffic, limits=limits)


def derive_seed(seed: int, *index: int) -> int:
    """A seed for the index-th draw of a run, below 2**63: the same
    ``--seed`` gives the same draws."""
    x = int(seed) % (1 << 64)
    for i in index:
        x = (x * 0x9E3779B97F4A7C15 + int(i) + 1) % (1 << 64)
        x ^= x >> 29
    return x % (1 << 63)


class RouteSink(io.TextIOBase):
    """Stands in for stdout around the program's calls: keeps each
    distinct routing line and counts the rest, so that the result is the
    last line of the benchmark's own output."""

    def __init__(self):
        self.routes: list = []
        self.lines = 0
        self._buf = ""

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        self._buf += s
        *done, self._buf = self._buf.split("\n")
        for line in done:
            self.lines += 1
            if line.startswith(ROUTE_PREFIX) and line not in self.routes:
                self.routes.append(line)
        return len(s)


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in BANNED)


def card_lines(device) -> list:
    """The card's and the host's particulars, for the earlier lines."""
    out = []
    if device.type == "cuda":
        q = ("name,power.limit,power.max_limit,clocks.sm,clocks.max.sm,"
             "clocks.mem,temperature.gpu")
        try:
            smi = subprocess.run(
                ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            smi = f"nvidia-smi failed: {e}"
        out.append(f"card: {torch.cuda.get_device_name(device)}; "
                   f"nvidia-smi ({q}): {smi}")
    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    out.append(f"host: {model}; {os.cpu_count()} threads; torch "
               f"{torch.__version__} cuda {torch.version.cuda}; python "
               f"{sys.version.split()[0]}")
    return out
