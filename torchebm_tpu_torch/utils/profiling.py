r"""Profiling helpers (counterpart of :mod:`torchebm_tpu.utils.profiling`).

- :func:`profile_context` records the block with ``torch.profiler`` (CPU and,
  where there is a card, CUDA activity) and writes a Chrome trace to
  ``log_dir`` on exit.
- :func:`record_function` is ``torch.profiler.record_function``, for naming
  regions of a hot loop.
- :func:`benchmark_fn` times a callable on the host clock, each call fenced
  by ``torch.cuda.synchronize`` so queued device work is inside the reading.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Any, Callable, Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["profile_context", "record_function", "benchmark_fn"]


@contextlib.contextmanager
def profile_context(log_dir: str):
    """Profile everything inside the block; yields the profiler and writes
    ``<log_dir>/trace.json`` (open it in Perfetto or ``chrome://tracing``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def benchmark_fn(fn: Callable[[], Any], *, warmup: int = 2, iters: int = 10) -> Dict[str, float]:
    """Median, minimum and mean seconds of ``fn()`` over ``iters`` calls
    after ``warmup`` calls, each call followed by a device synchronise."""
    for _ in range(warmup):
        fn()
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    return {
        "median_s": statistics.median(times),
        "min_s": min(times),
        "mean_s": statistics.fmean(times),
        "iters": float(iters),
    }
