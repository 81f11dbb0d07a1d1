"""Training objectives (counterpart of ``torchebm_tpu.losses``): the loss
contract, the shared utilities, and CD/PCD/PT-CD. Score matching and the
flow-family losses come with later slices."""

from .base import BaseLoss, inject_params
from .contrastive_divergence import (
    ContrastiveDivergence,
    ParallelTemperingCD,
    PersistentContrastiveDivergence,
    ReplayBuffer,
)
from .loss_utils import (
    compute_eqm_ct,
    compute_flow_weight,
    dispersive_loss,
    mean_flat,
    trimmed_mean,
)

__all__ = [
    "BaseLoss",
    "inject_params",
    "ContrastiveDivergence",
    "PersistentContrastiveDivergence",
    "ParallelTemperingCD",
    "ReplayBuffer",
    "mean_flat",
    "trimmed_mean",
    "compute_flow_weight",
    "compute_eqm_ct",
    "dispersive_loss",
]
