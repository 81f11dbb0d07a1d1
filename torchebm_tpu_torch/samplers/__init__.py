"""MCMC samplers (counterpart of ``torchebm_tpu.samplers``): the shared loop and
Langevin dynamics with its whole-chain kernel dispatch."""

from .base import BaseSampler
from .langevin import FUSED_DISPATCH, LangevinDynamics

__all__ = ["BaseSampler", "LangevinDynamics", "FUSED_DISPATCH"]
