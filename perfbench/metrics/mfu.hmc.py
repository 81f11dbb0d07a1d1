"""The whole sampling call's share of the card's peak: the frozen count's
least time of one call times the window's calls, over the window's
host-clock seconds. It reads below the kernel's roofline share, and reads
whatever path the call takes."""

from perfbench.counts.chains import bound_s


def read(ctx):
    work, peaks, win = ctx["work"], ctx["peaks"], ctx["window"]
    if peaks is None or "chain_work" not in work:
        return None
    return 100.0 * bound_s(work["chain_work"], peaks) * win["calls"] / win["seconds"]
