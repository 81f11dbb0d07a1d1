"""A traced window under ``torch.profiler`` and its reduction from raw events.

Each profile is padded by ``PAD_S`` of host sleep before the window and after
its closing ``synchronize()``: on an H100 with torch 2.11, 12 of 443 unpadded
profiles lost some or all of a short call's device events and none of the
padded ones did; a profile that records no device event is taken again, up
to ``PROFILES`` times. Device time is summed from the profile's raw events
(``kineto_results.events()``), not ``key_averages()``, whose tables take
minutes on a million events. (Frozen from ``chip_smoke.py::profiled`` and
``device_busy_ms`` at commit 1f6b563.)

The window is the span of a ``perfbench.window`` annotation around the
traced calls and their synchronise. Within it: the device's busy time is
the union of its operations' intervals (kernels, copies and sets, not
annotations); an idle gap is a stretch of the window in which no device
operation runs, named after the host operation that overlaps it most (the
shortest such, so the innermost), or ``host between ops``.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

PAD_S = 0.02
PROFILES = 3
WINDOW = "perfbench.window"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(events) -> dict:
    """``{"window_s", "busy_s", "device_ops": {name: s}, "idle_gaps":
    {name: s}}`` from a profile's raw events."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    windows = [e for e in events if e.name() == WINDOW and e.device_type() == cpu]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} spans, not one")
    w0 = windows[0].start_ns()
    w1 = w0 + windows[0].duration_ns()
    ops: Dict[str, float] = {}
    spans = []
    host = []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if e.device_type() == cuda and not e.is_user_annotation():
            ops[e.name()] = ops.get(e.name(), 0.0) + (b - a) / 1e9
            spans.append((a, b))
        elif e.device_type() == cpu and not e.name().startswith("perfbench."):
            host.append((a, b, e.name()))
    busy = _union(spans)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return {"window_s": (w1 - w0) / 1e9, "busy_s": sum(b - a for a, b in busy) / 1e9,
            "device_ops": ops, "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle gap by the host operation that overlaps each gap most."""
    starts = [a for a, _ in gaps]
    best = [(0, 0, "host between ops")] * len(gaps)  # (overlap, -duration, name)
    for a, b, name in host:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(gaps) and gaps[i][0] < b:
            ga, gb = gaps[i]
            over = min(b, gb) - max(a, ga)
            if over > 0 and (over, -(b - a)) > best[i][:2]:
                best[i] = (over, -(b - a), name)
            i += 1
    named: Dict[str, float] = {}
    for (ga, gb), (_, _, name) in zip(gaps, best):
        named[name] = named.get(name, 0.0) + (gb - ga) / 1e9
    return named


def traced(run: Callable[[], None], sync: Callable[[], None], on_device: bool) -> dict:
    """One padded profile around ``run()`` and ``sync()``, reduced; taken
    again (up to ``PROFILES`` times) while it records no device operation
    on a card."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_device else [])
    for _ in range(PROFILES):
        with profile(activities=acts) as prof:
            time.sleep(PAD_S)
            with record_function(WINDOW):
                run()
                sync()
            time.sleep(PAD_S)
        out = reduce(prof.profiler.kineto_results.events())
        if out["device_ops"] or not on_device:
            return out
    return out


def top(table: Dict[str, float], n: int = 10) -> list:
    """The ``n`` largest entries as ``[[name, seconds], ...]``."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
