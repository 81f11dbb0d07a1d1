"""torchebm_tpu_torch: the PyTorch and CUDA port of ``torchebm_tpu``.

A second package beside the JAX one, with the same module layout, so each
module's counterpart is found under the same name. It imports ``torch`` and
never ``jax``. Energies are ``nn.Module``\\ s with their parameters as buffers,
randomness comes from explicit ``torch.Generator``\\ s, and the device is the
generator's. The whole-chain Langevin kernels are hand-written CUDA for
Hopper (``ops/csrc``), built at first use.

Ported so far: the Langevin sampling path (energies, schedulers,
Euler–Maruyama, the sampling loop, ``LangevinDynamics`` with its dispatch
rows and kernels) and parameter conversion from the JAX package.

Subpackages and symbols load lazily through module ``__getattr__``.
"""

from __future__ import annotations

import importlib

__version__ = "0.5.0"

_SUBMODULES = ("core", "integrators", "samplers", "ops", "utils")

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
    # samplers
    "LangevinDynamics": "samplers",
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
