"""Milliseconds per sampling call that are not the chain kernel: the traced
window less the kernel's device time, over the calls (the sampler's
arguments, its seed's host read, the schedule's copy, the launch)."""

from perfbench.readers import chain_kernel_s


def read(ctx):
    spent = chain_kernel_s(ctx)
    if spent is None:
        return None
    tr = ctx["trace"]
    return 1e3 * (tr["window_s"] - spent) / tr["calls"]
