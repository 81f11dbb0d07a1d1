"""Device milliseconds per MMDiT training step in attention kernels, forward
and backward, sorted by name with ``kernel_classes.json``: every attention of
the MMDiT is one block's joint attention over its image and text tokens. Read
from the device trace, so a step replayed from CUDA graphs is read as it
runs. None where the traced window ran no attention kernel."""

from perfbench.readers import kernel_class


def read(ctx):
    tr = ctx["trace"]
    spent = [s for name, s in tr["device_ops"].items()
             if kernel_class(name, ctx["classes"]) == "attention"]
    if not spent:
        return None
    return 1e3 * sum(spent) / tr["calls"]
