"""Core contracts: energies and schedulers (counterpart of ``torchebm_tpu.core``).

The trainer lives in :mod:`.trainer`; ``BaseTrainer``,
``ContrastiveDivergenceTrainer`` and ``TrainState`` are forwarded lazily, as
the JAX package does, so importing ``core`` does not import the losses."""

from .module import default_device, warn_once
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


_TRAINER = ("BaseTrainer", "ContrastiveDivergenceTrainer", "TrainState")


def __getattr__(name):
    if name in _TRAINER:
        from . import trainer

        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
