"""Profiling and timing on PyTorch (the port's counterpart of
``qoc_tpu.utils.profiling``, which is built on ``jax.profiler``).

The same three names and return shapes: ``trace`` captures a
``torch.profiler`` trace of a region into a directory (a Chrome trace,
readable in Perfetto or ``chrome://tracing``), ``time_fn`` times a
callable with the card synchronised, and ``memory_stats`` reads the
device allocator's statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region into ``log_dir/trace.json`` (Chrome trace
    format): CPU activity, and CUDA activity when torch sees a card.
    Yields the ``torch.profiler.profile`` object (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card when any tensor of ``out`` lies on it."""
    def cuda_tensors(x):
        if isinstance(x, torch.Tensor):
            yield x.is_cuda
        elif isinstance(x, dict):
            for v in x.values():
                yield from cuda_tensors(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from cuda_tensors(v)

    if any(cuda_tensors(out)):
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
            **kwargs) -> dict:
    """Time ``fn(*args, **kwargs)``, synchronising with the card
    (``torch.cuda.synchronize``) when an output is a CUDA tensor.

    Returns {compile_s, mean_s, iters_per_sec}.  ``compile_s`` is the
    first call's wall time: on the card it includes the nvcc build of the
    kernels at their first launch in the process, and the first call's
    cuBLAS and allocator set-up.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    mean = (time.perf_counter() - t0) / iters
    return {
        "compile_s": compile_s,
        "mean_s": mean,
        "iters_per_sec": 1.0 / mean if mean > 0 else float("inf"),
    }


def memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats(device)`` plus ``max_memory_allocated``
    on a CUDA device (``None``: the current card); ``None`` on the CPU,
    which keeps no allocator statistics."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = dict(torch.cuda.memory_stats(device))
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    return stats
