"""Numerical integrators (counterpart of ``torchebm_tpu.integrators``): the
explicit Runge-Kutta, SDE and symplectic bases, Euler–Maruyama, leapfrog and
the registry."""

from .base import (
    BaseIntegrator,
    BaseRungeKuttaIntegrator,
    BaseSDERungeKuttaIntegrator,
    BaseSymplecticIntegrator,
)
from .euler_maruyama import EulerMaruyamaIntegrator
from .leapfrog import LeapfrogIntegrator
from .registry import INTEGRATOR_REGISTRY, get_integrator, resolve_integrator

__all__ = [
    "BaseIntegrator",
    "BaseRungeKuttaIntegrator",
    "BaseSDERungeKuttaIntegrator",
    "BaseSymplecticIntegrator",
    "EulerMaruyamaIntegrator",
    "LeapfrogIntegrator",
    "INTEGRATOR_REGISTRY",
    "get_integrator",
    "resolve_integrator",
]
