"""Host waits for the card's stream per sampling call: the rise of the
port's counter ``host_reads`` (a device value read into Python, or host
numbers copied to the card) over its root span ``sampler.sample``; the mean
over the traced calls
(the last ``calls`` roots). None where the port records no such span or
the cell runs another kernel."""

KERNEL = "mixture_hmc_chain"


def read(ctx):
    from torchebm_tpu_torch.utils import profiling

    if ctx["work"].get("kernel") != KERNEL or not hasattr(profiling, "spans"):
        return None
    roots = [s for s in profiling.spans() if s.parent is None and s.name == "sampler.sample"]
    reads = [r.counts.get("host_reads", 0) for r in roots[-ctx["trace"]["calls"]:]]
    return sum(reads) / len(reads) if reads else None
