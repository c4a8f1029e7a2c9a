"""The traced window: ``torch.profiler``'s events, kept in memory as plain
tuples, and the arithmetic the per-layer metrics share (the union of the
device's busy intervals, the idle gaps and what the host ran in them).

Nothing is written to disk: the events are read from the profiler's
results in memory (``kineto_results.events()``), never through a Chrome
trace.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160           # a name in the breakdown (kernel names run long)


class Event(NamedTuple):
    name: str
    kind: str      # "device", "launch" (a CUDA launch or copy call), "host"
    start: int     # ns, on the profiler's clock
    end: int


def _is_launch(name: str) -> bool:
    return "Launch" in name or "Memcpy" in name or "Memset" in name


def kinds(events) -> dict:
    """How many events of each kind, for the run's earlier lines."""
    out = {}
    for e in events:
        out[e.kind] = out.get(e.kind, 0) + 1
    return out


def from_kineto(kevents) -> list:
    """Plain events from the profiler's results: device kernels, copies
    and sets; the host's CUDA launch and copy calls; and every other host
    event (operators, the benchmark's spans, other API calls)."""
    out = []
    for e in kevents:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        act = e.activity_type() if hasattr(e, "activity_type") else ""
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device:
            if act in DEVICE_ACTIVITIES or (not act
                                            and not e.is_user_annotation()):
                out.append(Event(name, "device", start, end))
            continue
        if (act in HOST_API or (not act and name.startswith("cu"))) and (
                _is_launch(name)):
            out.append(Event(name, "launch", start, end))
        else:
            out.append(Event(name, "host", start, end))
    return out


class Tracer:
    """Profile CPU and CUDA activity between ``start`` and ``stop``; the
    events come back from ``events()``."""

    def __init__(self):
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False, profile_memory=False)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def events(self) -> list:
        return from_kineto(self._prof.profiler.kineto_results.events())


def spans(events, name: str) -> list:
    """(start, end) of the benchmark's spans called ``name``."""
    return sorted((e.start, e.end) for e in events
                  if e.kind == "host" and e.name == name)


def union(events, lo: int, hi: int) -> list:
    """The device's busy intervals inside [lo, hi], merged."""
    ivs = sorted((max(e.start, lo), min(e.end, hi)) for e in events
                 if e.kind == "device" and e.end > lo and e.start < hi)
    merged = []
    for s, t in ivs:
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                merged[-1][1] = t
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_ns(events, lo: int, hi: int) -> int:
    return sum(t - s for s, t in union(events, lo, hi))


def gaps(events, lo: int, hi: int) -> list:
    """The idle intervals of the device inside [lo, hi]."""
    out, at = [], lo
    for s, t in union(events, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if hi > at:
        out.append((at, hi))
    return out


def device_count(events, lo: int, hi: int) -> int:
    """Kernels, copies and sets that start inside [lo, hi]."""
    return sum(1 for e in events
               if e.kind == "device" and lo <= e.start < hi)


def host_at(events, points) -> list:
    """For each time in ``points`` (sorted), the innermost host event
    running then (the latest-started one not yet ended), or None."""
    host = sorted((e.start, e.end, e.name) for e in events
                  if e.kind in ("host", "launch"))
    heap, out, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            s, t, n = host[i]
            heapq.heappush(heap, (-s, t, n))
            i += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def breakdown(events, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    the host operation running in each gap (at its middle), in seconds."""
    by_op = {}
    for e in events:
        if e.kind == "device" and e.end > lo and e.start < hi:
            d = min(e.end, hi) - max(e.start, lo)
            by_op[e.name] = by_op.get(e.name, 0) + d
    idle = gaps(events, lo, hi)
    mids = [(s + t) // 2 for s, t in idle]
    by_host = {}
    for (s, t), name in zip(idle, host_at(events, mids)):
        key = name or "(no host event)"
        by_host[key] = by_host.get(key, 0) + (t - s)

    def ranked(d):
        return [[k[:NAME_CHARS], v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
