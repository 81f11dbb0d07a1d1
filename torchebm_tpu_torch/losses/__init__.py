"""Training objectives (counterpart of ``torchebm_tpu.losses``): the loss
contract, the shared utilities, CD/PCD/PT-CD, score matching (exact and
approximate Hyvärinen, denoising, sliced), Equilibrium Matching and Energy
Matching."""

from .base import BaseLoss, inject_params
from .contrastive_divergence import (
    ContrastiveDivergence,
    ParallelTemperingCD,
    PersistentContrastiveDivergence,
    ReplayBuffer,
)
from .energy_matching import EnergyMatchingLoss
from .equilibrium_matching import EquilibriumMatchingLoss
from .score_matching import (
    BaseScoreMatching,
    DenoisingScoreMatching,
    ScoreMatching,
    SlicedScoreMatching,
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
    "ScoreMatching",
    "DenoisingScoreMatching",
    "SlicedScoreMatching",
    "BaseScoreMatching",
    "EquilibriumMatchingLoss",
    "EnergyMatchingLoss",
    "mean_flat",
    "trimmed_mean",
    "compute_flow_weight",
    "compute_eqm_ct",
    "dispersive_loss",
]
