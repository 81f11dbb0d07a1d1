"""Device milliseconds per training step in operations that are neither
matrix products nor attention (norms, modulation, GELU, residuals, casts,
AdamW, the EMA, copies), sorted by name with ``kernel_classes.json``."""

from perfbench.readers import kernel_class


def read(ctx):
    tr = ctx["trace"]
    if not tr["device_ops"]:
        return None
    rest = sum(s for name, s in tr["device_ops"].items()
               if kernel_class(name, ctx["classes"]) == "rest")
    return 1e3 * rest / tr["calls"]
