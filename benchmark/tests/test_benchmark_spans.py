"""The readers of the program's spans on synthetic events: each takes the
spans wholly inside the traced window, reads either entry's span where
its metric has a ``.single`` and a ``.batch``, and returns None when the
program recorded none (a parent without spans, a run on the CPU); and
the entries that name them keep the contract."""

import pytest

from benchmark import harness
from benchmark.trace import Event
from test_benchmark_harness import BENCH, _read, _synthetic

MS = 1_000_000
SPAN_METRICS = {
    "front_end_ms.single": ["leakage.single", "multimode.single"],
    "front_end_ms.batch": ["leakage.restarts", "multimode.sweep"],
    "readout_ms.single": ["leakage.single", "multimode.single"],
    "boundary_us.single": ["leakage.single", "multimode.single"],
    "boundary_us.batch": ["leakage.restarts"],
    "launch_prep_us.single": ["leakage.single"],
    "launch_prep_us.batch": ["leakage.restarts"],
    "enqueue_ms.single": ["multimode.single"],
    "enqueue_ms.batch": ["multimode.sweep"],
    "enqueue_ms.batch.x4": ["multimode.sweep_x4"],
}


def _window(*spans):
    """``_synthetic()``'s context stretched to a 1 s window holding the
    host spans (name, start ms, end ms), and one span that starts before
    the window and one that ends after it."""
    ctx = _synthetic()
    ctx.hi = 1000 * MS
    ctx.events = ctx.events + [
        Event(name, "host", int(a * MS), int(b * MS)) for name, a, b in spans]
    return ctx


def _straddling(name):
    return [Event(name, "host", -5 * MS, 5 * MS),
            Event(name, "host", 990 * MS, 1010 * MS)]


@pytest.mark.parametrize("metric,name,unit", [
    ("front_end_ms.single", "qoc.grape.front_end", 1.0),
    ("front_end_ms.batch", "qoc.batch.front_end", 1.0),
    ("readout_ms.single", "qoc.grape.readout", 1.0),
    ("boundary_us.single", "qoc.grape.boundary", 1e3),
    ("boundary_us.batch", "qoc.batch.boundary", 1e3),
    ("launch_prep_us.single", "qoc.mega.prepare", 1e3),
    ("launch_prep_us.batch", "qoc.mega_batch.prepare", 1e3),
])
def test_a_span_reader_takes_the_median_inside_the_window(metric, name, unit):
    ctx = _window((name, 10, 12), (name, 100, 104), (name, 200, 209),
                  ("qoc.other.span", 300, 400))
    ctx.events += _straddling(name)
    assert _read(metric, ctx) == pytest.approx(4.0 * unit)


@pytest.mark.parametrize("metric", ["front_end_ms", "boundary_us",
                                    "launch_prep_us"])
def test_the_single_and_batch_readers_read_either_entry(metric):
    names = {"front_end_ms": ("qoc.grape.front_end", "qoc.batch.front_end"),
             "boundary_us": ("qoc.grape.boundary", "qoc.batch.boundary"),
             "launch_prep_us": ("qoc.mega.prepare",
                                "qoc.mega_batch.prepare")}[metric]
    for name in names:
        ctx = _window((name, 10, 13))
        assert _read(metric + ".single", ctx) == _read(metric + ".batch",
                                                       ctx) > 0


def test_enqueue_sums_grad_and_update_per_iteration():
    ctx = _window(("qoc.step.grad", 10, 11), ("qoc.step.read", 11, 50),
                  ("qoc.step.update", 50, 50.5), ("qoc.step.grad", 60, 63),
                  ("qoc.step.read", 63, 90), ("qoc.step.update", 90, 90.5))
    ctx.events += _straddling("qoc.step.grad")
    for cell in ("single", "batch"):
        assert _read("enqueue_ms." + cell, ctx) == pytest.approx(2.5)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_span_reader_finds_nothing_without_spans(metric):
    assert _read(metric, _synthetic()) is None
    ctx = _window()
    for name in ("qoc.grape.front_end", "qoc.grape.readout",
                 "qoc.grape.boundary", "qoc.mega.prepare",
                 "qoc.step.grad"):
        ctx.events += _straddling(name)
    assert _read(metric, ctx) is None


def test_the_span_metrics_keep_the_contract():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    layers = {m["layer"] for m in BENCH["per_layer"]
              if m["name"] not in SPAN_METRICS}
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[-len(SPAN_METRICS):] == list(SPAN_METRICS)
    for name, cells in SPAN_METRICS.items():
        m = entries[name]
        assert m["workloads"] == cells and m["source"] == "device_trace"
        assert m["layer"] in layers
        assert harness.metric_path(name).exists()
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert set(cells) <= set(moved[0]["workloads"])


def test_the_allreduce_reader_takes_the_median_over_segments_and_ranks():
    """Each rank keeps its all-reduce kernels that start inside its window
    (not the gathers, the broadcast or the barrier before the window);
    rank 0 takes the median of every rank's."""
    reader = harness.load_module(harness.metric_path("allreduce_ms.batch"),
                                 "m_allreduce")
    ar = "ncclDevKernel_AllReduce_Sum_u64_RING_LL(ncclDevKernelArgsStorage)"
    ctx = _window()
    ctx.events += [Event(ar, "device", -3 * MS, -2 * MS),
                   Event(ar, "device", 100 * MS, 102 * MS),
                   Event(ar, "device", 500 * MS, 506 * MS),
                   Event("ncclDevKernel_AllGather_RING_LL", "device",
                         510 * MS, 530 * MS),
                   Event("ncclDevKernel_Broadcast_RING_LL", "device",
                         540 * MS, 560 * MS),
                   Event(ar, "host", 700 * MS, 760 * MS)]
    mine = reader.per_rank(ctx)
    assert mine == pytest.approx([2.0, 6.0])
    ctx.per_rank = [mine, [1.0, 3.0], [4.0], None]
    assert reader.read(ctx) == pytest.approx(3.0)
    ctx.per_rank = [[], None]
    assert reader.read(ctx) is None
    assert reader.per_rank(_synthetic()) == []
    entry = {m["name"]: m for m in BENCH["per_layer"]}["allreduce_ms.batch"]
    assert entry["workloads"] == ["multimode.sweep_x4"]
    assert entry["layer"] == "batch layer" and entry["unit"] == "ms"
    assert entry["moves"] == "seed_iters_per_s.x4"
