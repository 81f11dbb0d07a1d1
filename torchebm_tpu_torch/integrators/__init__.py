"""Numerical integrators (counterpart of ``torchebm_tpu.integrators``): the
explicit Runge-Kutta and SDE bases, Euler–Maruyama and the registry."""

from .base import BaseIntegrator, BaseRungeKuttaIntegrator, BaseSDERungeKuttaIntegrator
from .euler_maruyama import EulerMaruyamaIntegrator
from .registry import INTEGRATOR_REGISTRY, get_integrator, resolve_integrator

__all__ = [
    "BaseIntegrator",
    "BaseRungeKuttaIntegrator",
    "BaseSDERungeKuttaIntegrator",
    "EulerMaruyamaIntegrator",
    "INTEGRATOR_REGISTRY",
    "get_integrator",
    "resolve_integrator",
]
