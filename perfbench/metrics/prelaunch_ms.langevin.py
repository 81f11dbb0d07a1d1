"""Host milliseconds per sampling call from the start of the port's root
span ``sampler.sample`` to the end of its kernel wrapper's span
``ops.mixture_langevin_chain`` (the launch queued): the initial state, the
dispatch gates, the seed and the wrapper, while the card waits for the chain
kernel; the mean over the traced calls (the last ``calls`` roots). None
where the port records no such span or the cell runs another kernel."""

KERNEL = "mixture_langevin_chain"


def read(ctx):
    from torchebm_tpu_torch.utils import profiling

    if ctx["work"].get("kernel") != KERNEL or not hasattr(profiling, "spans"):
        return None
    roots = [s for s in profiling.spans() if s.parent is None and s.name == "sampler.sample"]
    ms = [(c.end_ns - r.start_ns) / 1e6 for r in roots[-ctx["trace"]["calls"]:]
          for c in r.children if c.name == f"ops.{KERNEL}"]
    return sum(ms) / len(ms) if ms else None
