"""Model FLOPs utilisation of guided generation: the frozen DiT count of
two forwards per Euler step times steps, samples and calls, over the
window's host-clock seconds, as a share of the card's dense bf16 peak."""

from perfbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx)
