"""Device milliseconds per training step, on rank 0's card, of the
operations whose names contain ``nccl``: FSDP2's all-gathers and
reduce-scatters over the ``fsdp`` axis, the gradients' all-reduce over the
``data`` axis and the replicated parameters' mean. They run on NCCL's own
streams beside the step's compute, so this is their time, not the step's
wait for them. None where the traced window ran no such operation."""


def read(ctx):
    tr = ctx["trace"]
    spent = [s for name, s in tr["device_ops"].items() if "nccl" in name.lower()]
    if not spent:
        return None
    return 1e3 * sum(spent) / tr["calls"]
