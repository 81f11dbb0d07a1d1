"""MCMC samplers (counterpart of ``torchebm_tpu.samplers``): the shared loop,
Langevin dynamics with its whole-chain kernel dispatch, gradient descent and
Nesterov, MALA, HMC with dual-averaging warmup, Riemannian-manifold HMC,
NUTS and the NUTS→HMC trajectory tuning, the R̂/ESS diagnostics, parallel
tempering, annealed importance sampling, and the flow sampler (ODE and SDE
generation from a trained field)."""

from .ais import AISResult, annealed_importance_sampling
from .base import BaseSampler
from .diagnostics import (
    effective_sample_size,
    potential_scale_reduction,
    summarize_chains,
    tail_effective_sample_size,
)
from .flow import FlowSampler, PredictionType, WrappedField
from .gradient_descent import GradientDescentSampler, NesterovSampler
from .hmc import DualAveragingState, HamiltonianMonteCarlo, dual_averaging_update
from .langevin import FUSED_DISPATCH, LangevinDynamics
from .mala import MetropolisAdjustedLangevin
from .nuts import NoUTurnSampler
from .parallel_tempering import ParallelTemperingLangevin
from .rmhmc import RiemannianManifoldHMC
from .tuning import TrajectoryTuning, tune_trajectory_length

__all__ = [
    "BaseSampler",
    "LangevinDynamics",
    "FUSED_DISPATCH",
    "GradientDescentSampler",
    "NesterovSampler",
    "MetropolisAdjustedLangevin",
    "HamiltonianMonteCarlo",
    "DualAveragingState",
    "dual_averaging_update",
    "RiemannianManifoldHMC",
    "NoUTurnSampler",
    "TrajectoryTuning",
    "tune_trajectory_length",
    "potential_scale_reduction",
    "effective_sample_size",
    "tail_effective_sample_size",
    "summarize_chains",
    "ParallelTemperingLangevin",
    "AISResult",
    "annealed_importance_sampling",
    "FlowSampler",
    "PredictionType",
    "WrappedField",
]
