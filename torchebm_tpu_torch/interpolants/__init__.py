"""Stochastic interpolants (counterpart of ``torchebm_tpu.interpolants``)."""

from .base import DIFFUSION_FORMS, BaseInterpolant, expand_t_like_x
from .interpolants import CosineInterpolant, LinearInterpolant, VariancePreservingInterpolant
from .registry import INTERPOLANT_REGISTRY, get_interpolant, resolve_interpolant

__all__ = [
    "BaseInterpolant",
    "expand_t_like_x",
    "DIFFUSION_FORMS",
    "LinearInterpolant",
    "CosineInterpolant",
    "VariancePreservingInterpolant",
    "INTERPOLANT_REGISTRY",
    "get_interpolant",
    "resolve_interpolant",
]
