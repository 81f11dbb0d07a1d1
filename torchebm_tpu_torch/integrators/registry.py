r"""Integrator registry: name → class resolution with family validation.

Counterpart of :mod:`torchebm_tpu.integrators.registry`. The generalised
leapfrog comes with Riemannian HMC.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from .adaptive_heun import AdaptiveHeunIntegrator
from .base import BaseIntegrator
from .bosh3 import Bosh3Integrator
from .dopri import Dopri5Integrator, Dopri8Integrator
from .euler_maruyama import BackwardEulerMaruyamaIntegrator, EulerMaruyamaIntegrator
from .heun import HeunIntegrator
from .leapfrog import LeapfrogIntegrator
from .midpoint import MidpointIntegrator
from .rk4 import RK438Integrator, RK4Integrator

__all__ = ["INTEGRATOR_REGISTRY", "get_integrator", "resolve_integrator"]

INTEGRATOR_REGISTRY = {
    "euler": EulerMaruyamaIntegrator,
    "euler_maruyama": EulerMaruyamaIntegrator,
    "backward_euler": BackwardEulerMaruyamaIntegrator,
    "backward_euler_maruyama": BackwardEulerMaruyamaIntegrator,
    "heun": HeunIntegrator,
    "midpoint": MidpointIntegrator,
    "rk4": RK4Integrator,
    "rk438": RK438Integrator,
    "adaptive_heun": AdaptiveHeunIntegrator,
    "bosh3": Bosh3Integrator,
    "dopri5": Dopri5Integrator,
    "dopri8": Dopri8Integrator,
    "leapfrog": LeapfrogIntegrator,
}


def get_integrator(name: str, **kwargs) -> BaseIntegrator:
    """Instantiate an integrator by registry name."""
    if not isinstance(name, str):
        raise TypeError(f"Integrator name must be a string, got {type(name)}")
    key = name.lower()
    if key not in INTEGRATOR_REGISTRY:
        raise ValueError(
            f"Unknown integrator '{name}'. Available: {sorted(set(INTEGRATOR_REGISTRY))}"
        )
    return INTEGRATOR_REGISTRY[key](**kwargs)


def resolve_integrator(
    integrator: Union[str, BaseIntegrator, None],
    default: str,
    families: Optional[Sequence[str]] = None,
    **kwargs,
) -> BaseIntegrator:
    """Resolve a name/instance/None into an integrator, validating its family."""
    if integrator is None:
        integrator = default
    if isinstance(integrator, str):
        integrator = get_integrator(integrator, **kwargs)
    if not isinstance(integrator, BaseIntegrator):
        raise TypeError(
            f"integrator must be a string name or BaseIntegrator, got {type(integrator)}"
        )
    if families is not None and integrator.family not in families:
        raise ValueError(
            f"{type(integrator).__name__} has family '{integrator.family}', "
            f"expected one of {list(families)}."
        )
    return integrator
