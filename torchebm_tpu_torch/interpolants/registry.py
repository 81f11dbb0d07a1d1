"""Interpolant registry (counterpart of :mod:`torchebm_tpu.interpolants.registry`)."""

from __future__ import annotations

from typing import Union

from .base import BaseInterpolant
from .interpolants import (
    CosineInterpolant,
    LinearInterpolant,
    VariancePreservingInterpolant,
)

__all__ = ["INTERPOLANT_REGISTRY", "get_interpolant", "resolve_interpolant"]

INTERPOLANT_REGISTRY = {
    "linear": LinearInterpolant,
    "cosine": CosineInterpolant,
    "vp": VariancePreservingInterpolant,
}


def get_interpolant(name: str, **kwargs) -> BaseInterpolant:
    if not isinstance(name, str):
        raise TypeError(f"Interpolant name must be a string, got {type(name)}")
    key = name.lower()
    if key not in INTERPOLANT_REGISTRY:
        raise ValueError(
            f"Unknown interpolant '{name}'. Available: {sorted(INTERPOLANT_REGISTRY)}"
        )
    return INTERPOLANT_REGISTRY[key](**kwargs)


def resolve_interpolant(
    interpolant: Union[str, BaseInterpolant, None], default: str = "linear", **kwargs
) -> BaseInterpolant:
    if interpolant is None:
        interpolant = default
    if isinstance(interpolant, str):
        return get_interpolant(interpolant, **kwargs)
    if not isinstance(interpolant, BaseInterpolant):
        raise TypeError(
            f"interpolant must be a string name or BaseInterpolant, got {type(interpolant)}"
        )
    return interpolant
