"""Hand-written CUDA kernels for Hopper (counterpart of ``torchebm_tpu.ops``).

Importing this package builds nothing: the kernels are compiled at their
first launch on a CUDA tensor (see :mod:`._build`). CPU tensors take the
kernels' plain PyTorch versions.
"""

from .fused_langevin import (
    doublewell_langevin_chain,
    doublewell_langevin_chain_trajectory,
    launch_counts,
    mixture_langevin_chain,
    mixture_langevin_chain_trajectory,
    reset_launch_counts,
)

__all__ = [
    "doublewell_langevin_chain",
    "doublewell_langevin_chain_trajectory",
    "mixture_langevin_chain",
    "mixture_langevin_chain_trajectory",
    "launch_counts",
    "reset_launch_counts",
]
