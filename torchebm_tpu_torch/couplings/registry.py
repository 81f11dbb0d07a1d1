"""Coupling registry (counterpart of :mod:`torchebm_tpu.couplings.registry`).

``ReflowCoupling`` is instance-only (needs a model) and intentionally not
string-registrable, as in the JAX package.
"""

from __future__ import annotations

from typing import Union

from .base import BaseCoupling
from .ot import (
    ExactOTCoupling,
    GreedyCoupling,
    IndependentCoupling,
    SinkhornCoupling,
    UnbalancedSinkhornCoupling,
)

__all__ = ["COUPLING_REGISTRY", "get_coupling", "resolve_coupling"]

COUPLING_REGISTRY = {
    "independent": IndependentCoupling,
    "ot": ExactOTCoupling,
    "exact_ot": ExactOTCoupling,
    "sinkhorn": SinkhornCoupling,
    "unbalanced_sinkhorn": UnbalancedSinkhornCoupling,
    "greedy": GreedyCoupling,
}


def get_coupling(name: str, **kwargs) -> BaseCoupling:
    if not isinstance(name, str):
        raise TypeError(f"Coupling name must be a string, got {type(name)}")
    key = name.lower()
    if key not in COUPLING_REGISTRY:
        raise ValueError(
            f"Unknown coupling '{name}'. Available: {sorted(set(COUPLING_REGISTRY))}"
        )
    return COUPLING_REGISTRY[key](**kwargs)


def resolve_coupling(
    coupling: Union[str, BaseCoupling, None], default: str = "independent", **kwargs
) -> BaseCoupling:
    if coupling is None:
        coupling = default
    if isinstance(coupling, str):
        return get_coupling(coupling, **kwargs)
    if not isinstance(coupling, BaseCoupling):
        raise TypeError(
            f"coupling must be a string name or BaseCoupling, got {type(coupling)}"
        )
    return coupling
