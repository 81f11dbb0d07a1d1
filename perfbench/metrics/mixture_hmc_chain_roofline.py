"""Share of its roofline that the ``mixture_hmc_chain`` kernel reaches: the frozen
count's least time of one call (perfbench/counts/chains.py) over the
kernel's device time per call in the traced window."""

from perfbench.readers import chain_roofline_percent


def read(ctx):
    return chain_roofline_percent(ctx, "mixture_hmc_chain")
