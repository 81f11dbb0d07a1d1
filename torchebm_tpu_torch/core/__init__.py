"""Core contracts: energies and schedulers (counterpart of ``torchebm_tpu.core``)."""

from .module import warn_once
from .energies import (
    AckleyEnergy,
    DoubleWellEnergy,
    Energy,
    GaussianEnergy,
    GaussianMixtureEnergy,
    HarmonicEnergy,
    RastriginEnergy,
    RosenbrockEnergy,
    WrappedEnergy,
    as_energy,
)
from .schedulers import (
    BaseScheduler,
    ConstantScheduler,
    CosineScheduler,
    ExponentialDecayScheduler,
    LinearScheduler,
    MultiStepScheduler,
    TemperatureScheduler,
    WarmupScheduler,
    sched_init,
    sched_value,
)

__all__ = [
    "warn_once",
    "Energy",
    "WrappedEnergy",
    "as_energy",
    "DoubleWellEnergy",
    "GaussianEnergy",
    "GaussianMixtureEnergy",
    "HarmonicEnergy",
    "RosenbrockEnergy",
    "AckleyEnergy",
    "RastriginEnergy",
    "BaseScheduler",
    "ConstantScheduler",
    "ExponentialDecayScheduler",
    "LinearScheduler",
    "CosineScheduler",
    "MultiStepScheduler",
    "WarmupScheduler",
    "TemperatureScheduler",
    "sched_value",
    "sched_init",
]
