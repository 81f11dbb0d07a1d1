"""Hand-written CUDA kernels for Hopper (counterpart of ``torchebm_tpu.ops``).

Importing this package builds nothing: the kernels are compiled at their
first launch on a CUDA tensor (see :mod:`._build`). CPU tensors take the
kernels' plain PyTorch versions.
"""

from . import (
    fused_adaln,
    fused_ais,
    fused_hmc,
    fused_langevin,
    fused_mala,
    fused_mlp_langevin,
    fused_pt,
    fused_sinkhorn,
)
from ._build import launch_counts, reset_launch_counts
from .fused_adaln import (
    adaln_modulate,
    adaln_modulate_backward,
    gated_residual,
    gated_residual_backward,
)
from .fused_ais import mixture_ais_run
from .fused_hmc import mixture_hmc_chain, mixture_hmc_chain_trajectory
from .fused_langevin import (
    doublewell_langevin_chain,
    doublewell_langevin_chain_trajectory,
    fused_langevin_step,
    mixture_langevin_chain,
    mixture_langevin_chain_trajectory,
)
from .fused_mala import mixture_mala_chain, mixture_mala_chain_trajectory
from .fused_mlp_langevin import extract_mlp_layers, mlp_langevin_chain
from .fused_pt import pt_langevin_chain, pt_langevin_chain_trajectory
from .fused_sinkhorn import fits_fused_sinkhorn, sinkhorn_log_fused

__all__ = [
    "fused_langevin_step",
    "doublewell_langevin_chain",
    "doublewell_langevin_chain_trajectory",
    "mixture_langevin_chain",
    "mixture_langevin_chain_trajectory",
    "mixture_mala_chain",
    "mixture_mala_chain_trajectory",
    "mixture_hmc_chain",
    "mixture_hmc_chain_trajectory",
    "pt_langevin_chain",
    "pt_langevin_chain_trajectory",
    "mixture_ais_run",
    "mlp_langevin_chain",
    "extract_mlp_layers",
    "sinkhorn_log_fused",
    "fits_fused_sinkhorn",
    "adaln_modulate",
    "adaln_modulate_backward",
    "gated_residual",
    "gated_residual_backward",
    "launch_counts",
    "reset_launch_counts",
]
