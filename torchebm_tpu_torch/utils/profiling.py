r"""Profiling helpers (counterpart of :mod:`torchebm_tpu.utils.profiling`).

- :func:`profile_context` records the block with ``torch.profiler`` (CPU and,
  where there is a card, CUDA activity) and writes a Chrome trace to
  ``log_dir`` on exit.
- :func:`record_function` is ``torch.profiler.record_function``, for naming
  regions of a hot loop.
- :func:`benchmark_fn` times a callable on the host clock, each call fenced
  by ``torch.cuda.synchronize`` so queued device work is inside the reading.
- :func:`span` marks a phase of the library's own calls, and records it only
  while a ``torch.profiler`` session is running; :func:`spans` reads what was
  recorded, :func:`clear_spans` empties it.
- :func:`count` raises a counter and :func:`counters` reads the totals; they
  are always on. ``host_reads`` counts the places where a sampler, loss,
  coupling, trainer or kernel wrapper makes the host wait for the card's
  stream: a tensor's value read into Python, or host numbers copied to the
  card (a blocking copy). A place is counted on the CPU too, where it waits
  for nothing.

Spans
-----

The library opens a span around each phase of its calls:

=======================  =====================================================
``sampler.sample``       ``BaseSampler.sample``, the whole call (root)
``sampler.start``        validation and the initial state (``_start``)
``sampler.dispatch``     the whole-chain kernel's gates and arguments
``sampler.seed``         the kernel's Philox seed drawn from the generator
``ops.<wrapper>``        a kernel wrapper: argument checks, allocation, launch
``trainer.train_step``   ``BaseTrainer.train_step``, the whole step (root)
``trainer.forward``      the loss
``trainer.backward``     ``loss.backward()`` and the replicated gradients' mean
``trainer.optimizer``    the optimizer step, the EMA update and the metrics
=======================  =====================================================

The outermost open span is its call's root. It is kept in memory only; each
span inside it also enters a profiler annotation of its name, so the phases
tile the call in the profiler's trace without nesting. Open a trace written
by :func:`profile_context` in Perfetto: the phases lie on the host thread's
row above the ``aten::`` operations they ran, and a stretch where the card
sits idle lies under the phase that kept it waiting (``sampler.seed`` for the
seed's read on the host, ``ops.mixture_langevin_chain`` for a launch). The
trainer's phases also carry their device time (:attr:`SpanRecord.device_ms`)
between CUDA events on the current stream at each phase's entry and exit.

With no profiler running, :func:`span` costs one flag read and returns a
shared object whose ``with`` does nothing: about 0.3 µs on the host of an
H100 server; it enters no annotation, which in ``torch.profiler``'s Python
form costs 12–14 µs there even with the profiler off. While a profiler runs,
a span costs about 4 µs on that host: two clock reads, a copy of the counters
and, below the root, the profiler's C++ annotation.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = [
    "profile_context", "record_function", "benchmark_fn", "span", "spans", "clear_spans",
    "count", "counters", "SpanRecord", "SPAN_BUFFER",
]

#: the newest spans kept in memory; older ones are dropped
SPAN_BUFFER = 1 << 16

# the profiler's annotation in its C++ form where this build has one
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)

_COUNTS: Dict[str, int] = {"host_reads": 0}
_SPANS: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_CALL_IDS = itertools.count()
_OPEN = threading.local()


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


def count(name: str) -> None:
    """Raise counter ``name`` (a key of :func:`counters`) by one."""
    _COUNTS[name] += 1


def counters() -> Dict[str, int]:
    """``{counter: total since the process started}``."""
    return dict(_COUNTS)


class SpanRecord:
    """One recorded span, and the context manager that records it.

    ``name``; ``call``, the id every span of one call shares; ``parent``, the
    name of the span it ran inside (None for a root); ``start_ns`` and
    ``end_ns`` on ``time.time_ns``'s clock, which the profiler's events use;
    ``counts``, each counter's rise over the span; ``children``, the spans
    directly inside it, in the order they ended.
    """

    __slots__ = ("name", "call", "parent", "start_ns", "end_ns", "counts", "children",
                 "_device", "_events", "_annotation", "_before")

    def __init__(self, name: str, call: int = -1, parent: Optional[str] = None, device=None):
        self.name, self.call, self.parent = name, call, parent
        self.start_ns = self.end_ns = 0
        self.counts: Dict[str, int] = {}
        self.children: List["SpanRecord"] = []
        self._device = device
        self._events = self._annotation = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds the card's stream took from the span's entry to its
        exit (waiting for the span's work to finish), or None for a span that
        was given no CUDA device."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, call={self.call}, parent={self.parent!r}, "
                f"host_ms={self.host_ms:.4f}, counts={self.counts})")

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        if stack:
            self.call, self.parent = stack[-1].call, stack[-1].name
        else:
            self.call = next(_CALL_IDS)
        self._before = dict(_COUNTS)
        if self._device is not None and torch.device(self._device).type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        self.start_ns = time.time_ns()
        if stack:
            self._annotation = _annotation(self.name)
            self._annotation.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = _OPEN.stack
        stack.pop()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        before = self._before
        self.counts = {k: v - before[k] for k, v in _COUNTS.items()}
        if stack:
            stack[-1].children.append(self)
        _SPANS.append(self)
        return False


class _Off:
    """The span while no profiler runs."""

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str, device=None):
    """A context manager marking phase ``name`` of a call.

    While a ``torch.profiler`` session runs it records a :class:`SpanRecord`;
    a span opened inside another also enters a profiler annotation of
    ``name``. On a CUDA ``device`` it also times the span on the card. With
    no profiler running it does nothing.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return SpanRecord(name, device=device)


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first (a span after those inside it), at
    most :data:`SPAN_BUFFER` of them."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()
