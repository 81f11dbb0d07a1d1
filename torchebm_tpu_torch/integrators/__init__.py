"""Numerical integrators (counterpart of ``torchebm_tpu.integrators``): the
Runge-Kutta (fixed-step, embedded-pair adaptive and DIRK), SDE and symplectic
bases, the thirteen methods and the registry."""

from .adaptive_heun import AdaptiveHeunIntegrator
from .base import (
    AdaptiveStats,
    BaseIntegrator,
    BaseRungeKuttaIntegrator,
    BaseSDERungeKuttaIntegrator,
    BaseSymplecticIntegrator,
)
from .bosh3 import Bosh3Integrator
from .dopri import Dopri5Integrator, Dopri8Integrator
from .euler_maruyama import BackwardEulerMaruyamaIntegrator, EulerMaruyamaIntegrator
from .heun import HeunIntegrator
from .leapfrog import GeneralisedLeapfrogIntegrator, LeapfrogIntegrator
from .midpoint import MidpointIntegrator
from .registry import INTEGRATOR_REGISTRY, get_integrator, resolve_integrator
from .rk4 import RK438Integrator, RK4Integrator

__all__ = [
    "AdaptiveStats",
    "BaseIntegrator",
    "BaseRungeKuttaIntegrator",
    "BaseSDERungeKuttaIntegrator",
    "BaseSymplecticIntegrator",
    "EulerMaruyamaIntegrator",
    "BackwardEulerMaruyamaIntegrator",
    "HeunIntegrator",
    "MidpointIntegrator",
    "RK4Integrator",
    "RK438Integrator",
    "AdaptiveHeunIntegrator",
    "Bosh3Integrator",
    "Dopri5Integrator",
    "Dopri8Integrator",
    "LeapfrogIntegrator",
    "GeneralisedLeapfrogIntegrator",
    "INTEGRATOR_REGISTRY",
    "get_integrator",
    "resolve_integrator",
]
