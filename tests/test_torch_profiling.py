"""The port's profiling utilities on the CPU: ``time_fn``'s three keys,
``trace``'s Chrome trace file, and no device statistics off the card."""

import json
import os

import pytest
import torch

from qoc_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_time_fn_keys_and_counts():
    calls = []
    a = torch.randn(64, 64)

    def fn(x, scale=1.0):
        calls.append(scale)
        return (x @ x) * scale

    out = profiling.time_fn(fn, a, iters=5, warmup=3, scale=2.0)
    assert set(out) == {"compile_s", "mean_s", "iters_per_sec"}
    assert out["compile_s"] > 0 and out["mean_s"] > 0
    assert out["iters_per_sec"] == pytest.approx(1.0 / out["mean_s"])
    # the first call, warmup - 1 more, then the timed ones
    assert calls == [2.0] * (1 + 2 + 5)


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    a = torch.randn(32, 32)
    with profiling.trace(str(log_dir)) as prof:
        torch.mm(a, a)
    path = log_dir / "trace.json"
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_kernel_events_reads_the_device_kernels(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "mega_segment", "dur": 12.5},
        {"cat": "cpu_op", "name": "aten::mm", "dur": 3.0},
        {"cat": "kernel", "name": "gemm", "dur": 1.0},
        {"name": "no category"}]}))
    got = profiling.kernel_events(str(path))
    assert [(e["name"], e["dur"]) for e in got] == [("mega_segment", 12.5),
                                                      ("gemm", 1.0)]


def test_memory_stats_none_off_the_card(monkeypatch):
    assert profiling.memory_stats("cpu") is None
    assert profiling.memory_stats(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.memory_stats() is None
