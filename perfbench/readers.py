"""Arithmetic the per-layer metric readers share. A reader returns None when
its cell gives it nothing to read; a share of a peak or a roofline is never
made up as 0."""

from __future__ import annotations


def idle_percent(ctx):
    """The traced window's share in which no device operation ran."""
    tr = ctx["trace"]
    if not tr["device_ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_percent(ctx):
    """The window's FLOPs (the frozen count per call times the calls) over
    its host-clock seconds, as a share of the card's dense peak."""
    work, peaks, win = ctx["work"], ctx["peaks"], ctx["window"]
    if peaks is None or "flops_per_call" not in work:
        return None
    return 100.0 * work["flops_per_call"] * win["calls"] / win["seconds"] / peaks[work["peak"]]


def kernel_class(name: str, classes: dict) -> str:
    low = name.lower()
    for cls, patterns in classes["classes"]:
        if any(p in low for p in patterns):
            return cls
    return "rest"


def chain_kernel_s(ctx):
    """Device seconds of the cell's chain kernel in the traced window, or
    None when the cell runs none."""
    kernel = ctx["work"].get("kernel")
    if kernel is None:
        return None
    pattern = ctx["classes"]["chain_kernels"][kernel]
    found = [s for name, s in ctx["trace"]["device_ops"].items() if pattern in name]
    return sum(found) if found else None


def chain_roofline_percent(ctx, kernel: str):
    """The frozen count's least time of one call over the kernel's device
    time per traced call, for the cell whose chain kernel is ``kernel``."""
    from perfbench.counts.chains import bound_s

    if ctx["work"].get("kernel") != kernel or ctx["peaks"] is None:
        return None
    spent = chain_kernel_s(ctx)
    if not spent:
        return None
    return 100.0 * bound_s(ctx["work"]["chain_work"], ctx["peaks"]) / (spent / ctx["trace"]["calls"])
