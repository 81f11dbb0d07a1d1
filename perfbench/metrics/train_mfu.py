"""Model FLOPs utilisation of the training step: the frozen DiT count of a
step (three forwards) times the window's steps, over the window's
host-clock seconds, as a share of the card's dense bf16 peak."""

from perfbench.readers import mfu_percent


def read(ctx):
    return mfu_percent(ctx)
