"""torchebm_tpu_torch: the PyTorch and CUDA port of ``torchebm_tpu``.

A second package beside the JAX one, with the same module layout, so each
module's counterpart is found under the same name. It imports ``torch`` and
never ``jax``. Energies are ``nn.Module``\\ s with their parameters as buffers,
randomness comes from explicit ``torch.Generator``\\ s, and the device is the
generator's. The whole-chain Langevin, MALA, HMC, parallel-tempering, AIS
and neural (SiLU-MLP) Langevin kernels, the one-step Langevin kernel and the
whole-loop Sinkhorn kernel are hand-written CUDA for Hopper (``ops/csrc``),
built at first use.

Ported so far: the Langevin sampling path (energies, schedulers,
Euler–Maruyama, the sampling loop, ``LangevinDynamics`` with its dispatch
rows and kernels), the gradient-MCMC slice (gradient descent, Nesterov,
MALA, leapfrog, HMC with dual-averaging warmup, R̂/ESS diagnostics), the
advanced HMC samplers (the generalised leapfrog and Riemannian-manifold HMC,
batched NUTS with dual-averaging warmup, the NUTS→HMC trajectory tuning),
replica exchange (``ParallelTemperingLangevin``) and annealed importance
sampling, the public ``ops.fused_langevin_step``, CD/PCD training (the
SiLU-MLP and conv energies, the synthetic datasets and image loading, the CD,
PCD and PT-CD losses, the trainer with EMA, accumulation and checkpoints, and
the whole-chain neural Langevin kernel), the flow slice (interpolants, the
minibatch couplings with the one-launch Sinkhorn kernel, the fixed-step,
adaptive and implicit Runge-Kutta integrators, ``FlowSampler`` with ODE and
SDE generation and ``log_prob``, the Equilibrium Matching and Energy Matching
losses, ``MLPVelocityField`` and ``EqMEnergy``), the DiT family
(``ConditionalTransformer2D`` and its components, the label embedder,
classifier-free guidance, the interaction energy), the score-matching
losses (exact and approximate Hyvärinen, denoising, sliced), parameter,
sampler and network conversion from the JAX package, and the distributed
layer (``parallel``: ``DeviceMesh``, DTensor placements, FSDP2 and sharded
checkpoints on ``torch.distributed``).

Subpackages and symbols load lazily through module ``__getattr__``.
"""

from __future__ import annotations

import importlib

__version__ = "0.5.0"

_SUBMODULES = ("core", "integrators", "interpolants", "couplings", "samplers", "losses", "models",
               "datasets", "ops", "utils", "parallel")

# name -> submodule path for lazily re-exported symbols
_LAZY_SYMBOLS = {
    # core
    "Energy": "core",
    "WrappedEnergy": "core",
    "as_energy": "core",
    "DoubleWellEnergy": "core",
    "GaussianEnergy": "core",
    "GaussianMixtureEnergy": "core",
    "HarmonicEnergy": "core",
    "RosenbrockEnergy": "core",
    "AckleyEnergy": "core",
    "RastriginEnergy": "core",
    "BaseScheduler": "core",
    "ConstantScheduler": "core",
    "ExponentialDecayScheduler": "core",
    "LinearScheduler": "core",
    "CosineScheduler": "core",
    "MultiStepScheduler": "core",
    "WarmupScheduler": "core",
    "TemperatureScheduler": "core",
    "sched_value": "core",
    "sched_init": "core",
    # integrators
    "get_integrator": "integrators",
    "resolve_integrator": "integrators",
    "EulerMaruyamaIntegrator": "integrators",
    "LeapfrogIntegrator": "integrators",
    "GeneralisedLeapfrogIntegrator": "integrators",
    "BackwardEulerMaruyamaIntegrator": "integrators",
    "HeunIntegrator": "integrators",
    "MidpointIntegrator": "integrators",
    "RK4Integrator": "integrators",
    "RK438Integrator": "integrators",
    "AdaptiveHeunIntegrator": "integrators",
    "Bosh3Integrator": "integrators",
    "Dopri5Integrator": "integrators",
    "Dopri8Integrator": "integrators",
    # interpolants
    "LinearInterpolant": "interpolants",
    "CosineInterpolant": "interpolants",
    "VariancePreservingInterpolant": "interpolants",
    "get_interpolant": "interpolants",
    "resolve_interpolant": "interpolants",
    "expand_t_like_x": "interpolants",
    # couplings
    "CouplingResult": "couplings",
    "IndependentCoupling": "couplings",
    "ExactOTCoupling": "couplings",
    "SinkhornCoupling": "couplings",
    "UnbalancedSinkhornCoupling": "couplings",
    "GreedyCoupling": "couplings",
    "ReflowCoupling": "couplings",
    "get_coupling": "couplings",
    "resolve_coupling": "couplings",
    # samplers
    "LangevinDynamics": "samplers",
    "GradientDescentSampler": "samplers",
    "NesterovSampler": "samplers",
    "MetropolisAdjustedLangevin": "samplers",
    "HamiltonianMonteCarlo": "samplers",
    "DualAveragingState": "samplers",
    "dual_averaging_update": "samplers",
    "RiemannianManifoldHMC": "samplers",
    "NoUTurnSampler": "samplers",
    "TrajectoryTuning": "samplers",
    "tune_trajectory_length": "samplers",
    "potential_scale_reduction": "samplers",
    "effective_sample_size": "samplers",
    "tail_effective_sample_size": "samplers",
    "summarize_chains": "samplers",
    "ParallelTemperingLangevin": "samplers",
    "AISResult": "samplers",
    "annealed_importance_sampling": "samplers",
    "FlowSampler": "samplers",
    "PredictionType": "samplers",
    "WrappedField": "samplers",
    # training
    "BaseTrainer": "core.trainer",
    "ContrastiveDivergenceTrainer": "core.trainer",
    "TrainState": "core.trainer",
    "ContrastiveDivergence": "losses",
    "PersistentContrastiveDivergence": "losses",
    "ParallelTemperingCD": "losses",
    "ReplayBuffer": "losses",
    "ScoreMatching": "losses",
    "DenoisingScoreMatching": "losses",
    "SlicedScoreMatching": "losses",
    "BaseScoreMatching": "losses",
    "EquilibriumMatchingLoss": "losses",
    "EnergyMatchingLoss": "losses",
    # models
    "ConditionalTransformer2D": "models",
    "LabelClassifierFreeGuidance": "models",
    "InteractionModel": "models",
    "EqMEnergy": "models",
    "MLPEnergy": "models",
    "MLPVelocityField": "models",
    "ConvEnergy2D": "models",
    "patchify2d": "models",
    "unpatchify2d": "models",
    "ConvPatchEmbed2d": "models",
    "build_2d_sincos_pos_embed": "models",
    "MLPTimestepEmbedder": "models",
    "LabelEmbedder": "models",
    "modulate": "models",
    "MultiheadSelfAttention": "models",
    "FeedForward": "models",
    "AdaLNZeroBlock": "models",
    "AdaLNZeroPatchHead": "models",
    "JointTransformer2D": "models",
    # datasets
    "DATASET_REGISTRY": "datasets",
    "load_mnist": "datasets",
}

__all__ = list(_SUBMODULES) + list(_LAZY_SYMBOLS) + ["__version__"]


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name in _LAZY_SYMBOLS:
        mod = importlib.import_module(f".{_LAZY_SYMBOLS[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
